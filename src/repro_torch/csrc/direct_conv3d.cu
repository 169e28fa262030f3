// Direct 3D 'valid' cross-correlation (ZNNi's direct conv primitive).
//
// Replaces the Pallas kernel ``conv3d_blocked`` of
// src/repro/kernels/direct_conv3d/kernel.py:
//
//   out[s, j, x, y, z] = sum_{i, dx, dy, dz} w[j, i, dx, dy, dz]
//                                           * x[s, i, x + dx, y + dy, z + dz]
//
// No bias (the caller adds it, as in the reference).  The TPU kernel runs
// the k^3 offsets as (f'_blk x f) @ (f x tile) MXU matmuls with f' padded
// to 8.  Here every product is an fp32 FMA outside the tensor cores (TF32
// would miss the reference tolerance of atol 1e-3 / rtol 1e-4); sums run
// in another order than the plain version's.
//
// What bounds it on the H100.  n337 calls it at two opposite shapes.
// Layer 0 (x (2, 1, 148^3), w (80, 1, 2^3)) writes 2 GB of output from a
// 26 MB input and does 8 FMAs an output: the output write bounds it.  The
// last layer (x (1024, 80, 10^3), w (3, 80, 3^3)) reads 0.33 GB, writes
// 6 MB and does 3.4 G FMAs: bytes and operations each take ~0.1 ms at the
// card's peaks.  So there are two kernels, and conv3d_f32 picks one from
// the shapes: ``conv3d_plane`` when f * kx*ky*kz <= 16 (few products an
// output, so writing the output is the work) and its shared memory fits,
// else ``conv3d_column``.
//
// conv3d_plane.  The output of one (s, j, x) is a contiguous plane of
// n'y * n'z values.  The launcher cuts each plane into equal segments of at
// most 4,096 positions of the flattened (y, z) index (2,048 when f*k^3 >
// 8); an item is one (s, segment, x plane).  A persistent grid (as many
// blocks as fit on the card at once) gives each block a contiguous range of
// items, x fastest, so a block walks x through runs of one segment.  It
// first asks L2 to fetch every input row its items will read (evict-last),
// so the reads come as one burst and do not interleave with the writes;
// then it keeps the segment's rows (plus ky - 1, every z, every channel) of
// kx + 1 x planes in a shared-memory ring filled by cp.async one plane
// ahead, and all f' * f*k^3 weights in shared memory.  Each of its 512
// threads owns 8 consecutive positions (4 when f*k^3 > 8): it loads their
// f*k^3 input values into registers once a plane and applies them to every
// output channel j.  Per j the segment's outputs are staged in shared
// memory (two buffers, one barrier a j) and written with 16-byte stores
// whose quads start h floats before the segment (h = its offset past a
// 128-byte line), so every warp fills whole lines; quads crossing a
// segment's ends store their part as scalars.  On the card the writes go
// faster the longer each block's run of one channel plane is (14.4 KB at
// layer 0), hence the long segments.
//
// conv3d_column.  A thread owns a z column of 8 outputs of one (s, x, y)
// for FPT output channels (FPT = f' when f' <= 4, else 8, with a grid axis
// over the groups): 8 * FPT accumulators.  For each input channel and (dx,
// dy) it loads the input row's 8 + kz - 1 values into registers once (in
// 8-byte loads where rows are even) and applies them at every dz (4 dz
// offsets at a time), with each offset's FPT weights one broadcast float4
// from shared memory: at n337's last layer 10 input values and 3 weight
// loads per 72 FMAs.  A block of 128 threads holds a tile of (samples, x,
// y, z chunks); where one sample is small (8^3 outputs) it takes several
// samples.  Its input tile and weights come through two shared-memory
// stages of CH channels (about 8,192 input floats) by cp.async, 16-byte
// copies where a tile's x planes are whole runs (as a 10^3 sample-channel's
// are), the next stage landing while the current one is computed.  A
// tile's x planes sit 16 floats past a multiple of 32 apart, so at n337's
// last layer the 8-byte row loads of a half-warp hit distinct banks.  For
// k = 3^3 the (dx, dy, dz) loops are unrolled at compile time, which lets
// the compiler load the next row while the FMAs of this one run; other k
// run the same loops at run time.
//
// Flat offsets are 64-bit: the planner's own n337 plan on this card puts
// 80 * 451^3 = 7.3e9 outputs in one layer-0 sample.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
// 4 bytes, or 4 zero bytes when ``pred`` is false (nothing is read then)
__device__ __forceinline__ void cp_async4z(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>  // every cp.async group but the N newest has landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void prefetch_l2_keep(const void* p) {
  asm volatile("prefetch.global.L2::evict_last [%0];\n" ::"l"(p));
}

// n contiguous floats from device to shared memory by nthr threads;
// 16-byte copies on the aligned middle when both sides share an alignment
__device__ __forceinline__ void copy_run(float* dst, const float* src, int n, int tid,
                                         int nthr) {
  const unsigned sa = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src) & 15);
  if (((smem_addr(dst) & 15) != sa) || n < 8) {
    for (int e = tid; e < n; e += nthr) cp_async4(dst + e, src + e);
    return;
  }
  const int head = static_cast<int>(((16 - sa) & 15) >> 2);
  const int nv = (n - head) >> 2;
  for (int e = tid; e < nv; e += nthr) cp_async16(dst + head + 4 * e, src + head + 4 * e);
  for (int e = tid; e < head; e += nthr) cp_async4(dst + e, src + e);
  for (int e = head + 4 * nv + tid; e < n; e += nthr) cp_async4(dst + e, src + e);
}

// ---------------------------------------------------------------------------
// conv3d_plane: output-bound shapes
constexpr int P_THREADS = 512;
constexpr size_t P_SMEM_MAX = 160 * 1024;

// positions a thread owns, for f*k^3 padded to KK terms
__host__ __device__ constexpr int plane_pos(int kk_pad) { return kk_pad <= 8 ? 8 : 4; }

// Write a segment's n outputs, staged in shared memory at st, to o: quad t
// covers positions [4t - h, 4t - h + 4), h = o's offset past a 128-byte
// line in floats, so every warp's 16-byte stores fill whole lines; the
// quads that cross either end of the segment store their part as scalars.
// R = (-h) & 3: where a quad starts inside the staged quads.
template <int R>
__device__ __forceinline__ void write_lines(float* o, const float* st, int n, int h,
                                            int tid) {
  const int nq = (n + h + 3) / 4;
  for (int t = tid; t < nq; t += P_THREADS) {
    const int m = 4 * t - h;
    if (m >= 0 && m + 4 <= n) {
      float4 q;
      if constexpr (R == 0) {
        q = *reinterpret_cast<const float4*>(st + m);
      } else {
        const float4 lo = *reinterpret_cast<const float4*>(st + m - R);
        const float4 hi = *reinterpret_cast<const float4*>(st + m - R + 4);
        q = R == 1 ? make_float4(lo.y, lo.z, lo.w, hi.x)
            : R == 2 ? make_float4(lo.z, lo.w, hi.x, hi.y)
                     : make_float4(lo.w, hi.x, hi.y, hi.z);
      }
      *reinterpret_cast<float4*>(o + m) = q;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (m + e >= 0 && m + e < n) o[m + e] = st[m + e];
    }
  }
}

// KK: f * kx*ky*kz rounded up to 8 or 16 (weights and values past it are 0)
template <int KK>
__global__ void __launch_bounds__(P_THREADS, 1)
conv3d_plane(const float* __restrict__ x, const float* __restrict__ w,
             float* __restrict__ out, int f, int fp, int nx, int ny, int nz, int kx,
             int ky, int kz, int npx, int npy, int npz, int seg_len, int nseg,
             int rows_max, long long n_items) {
  constexpr int POS = plane_pos(KK);
  constexpr int STAGE = P_THREADS * POS + 8;  // a staging buffer, and the last quad's reach
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [fp][KK]
  int* toff = reinterpret_cast<int*>(ws + fp * KK);  // term -> offset in a slot
  int* tdx = toff + KK;                              // term -> dx
  float* stage = reinterpret_cast<float*>(tdx + KK);  // [2][STAGE] outputs of one j
  float* ring = stage + 2 * STAGE;                    // [kx + 1][f][rows_max][nz]
  const int tid = threadIdx.x;
  const int k3 = kx * ky * kz, kk = f * k3;
  const int chan = rows_max * nz, slot = f * chan, slots = kx + 1;
  for (int e = tid; e < fp * KK; e += P_THREADS) {
    const int j = e / KK, r = e - j * KK;
    ws[e] = r < kk ? w[(long long)j * kk + r] : 0.f;
  }
  for (int r = tid; r < KK; r += P_THREADS) {
    int o = 0, d = 0;
    if (r < kk) {  // r = ((i * kx + dx) * ky + dy) * kz + dz, w's own order
      const int i = r / k3, t = r - i * k3;
      d = t / (ky * kz);
      const int u = t - d * ky * kz, dy = u / kz;
      o = i * chan + dy * nz + (u - dy * kz);
    }
    toff[r] = o;
    tdx[r] = d;
  }

  const long long A = (long long)npy * npz;  // one output plane
  const long long plane_in = (long long)ny * nz;
  const long long it0 = n_items * blockIdx.x / gridDim.x;
  const long long it1 = n_items * (blockIdx.x + 1) / gridDim.x;
  // segment seg: its first output row, the input rows it reads, its positions
  auto seg_rows = [&](int seg, int& oy_lo, int& rows, int& qn) {
    const long long q0 = (long long)seg * seg_len;
    qn = static_cast<int>(min((long long)seg_len, A - q0));
    oy_lo = static_cast<int>(q0 / npz);
    rows = static_cast<int>((q0 + qn - 1) / npz) - oy_lo + ky;
  };
  // every input row this block's items read, into L2 at once
  for (long long it = it0; it < it1;) {
    const long long rs = it / npx, run_end = min(it1, (rs + 1) * npx);
    int lo, nrow, n;
    seg_rows(static_cast<int>(rs % nseg), lo, nrow, n);
    const long long bytes = 4LL * nrow * nz;
    const int ix1 = static_cast<int>((run_end - 1) % npx) + kx - 1;
    for (int ix = static_cast<int>(it % npx); ix <= ix1; ++ix)
      for (int i = 0; i < f; ++i) {
        const char* base = reinterpret_cast<const char*>(
            x + (((rs / nseg) * f + i) * nx + ix) * plane_in + (long long)lo * nz);
        for (long long bo = 128LL * tid; bo < bytes + 124; bo += 128LL * P_THREADS)
          prefetch_l2_keep(base + min(bo, bytes - 4));
      }
    it = run_end;
  }

  const int a = tid * POS;
  int s = 0, qn = 0, oy_lo = 0, rows = 0, phase = 0;
  long long q0 = 0;
  int poff[POS];
  float v[POS][KK];
  for (long long it = it0; it < it1; ++it) {
    const int ox = static_cast<int>(it % npx);
    const bool fresh = it == it0 || ox == 0;  // a new run of one segment
    if (fresh) {
      const long long rs = it / npx;
      const int seg = static_cast<int>(rs % nseg);
      s = static_cast<int>(rs / nseg);
      q0 = (long long)seg * seg_len;
      seg_rows(seg, oy_lo, rows, qn);
#pragma unroll
      for (int e = 0; e < POS; ++e) {
        const long long q = q0 + a + e;
        const int oy = static_cast<int>(q / npz);
        poff[e] = a + e < qn ? (oy - oy_lo) * nz + static_cast<int>(q - (long long)oy * npz)
                             : -1;
      }
    }
    __syncthreads();  // the previous item is done with the ring
    // input plane ix of the segment's rows, every channel, into its slot
    auto load = [&](int ix) {
      float* dst = ring + (ix % slots) * slot;
      const float* src = x + ((long long)s * f * nx + ix) * plane_in + (long long)oy_lo * nz;
      for (int i = 0; i < f; ++i)
        copy_run(dst + i * chan, src + (long long)i * nx * plane_in, rows * nz, tid,
                 P_THREADS);
    };
    if (fresh)
      for (int dx = 0; dx < kx; ++dx) load(ox + dx);
    cp_async_commit();
    if (it + 1 < it1 && ox + 1 < npx) load(ox + kx);  // the slot of plane ox - 1
    cp_async_commit();
    cp_async_wait<1>();  // planes ox .. ox + kx - 1 have landed
    __syncthreads();
#pragma unroll
    for (int r = 0; r < KK; ++r) {
      const float* src = ring + ((ox + tdx[r]) % slots) * slot + toff[r];
#pragma unroll
      for (int e = 0; e < POS; ++e) v[e][r] = (r < kk && poff[e] >= 0) ? src[poff[e]] : 0.f;
    }

    const long long jstride = (long long)npx * A;
    float* o = out + ((long long)s * fp * npx + ox) * A + q0;
    for (int j = 0; j < fp; ++j, o += jstride, phase ^= 1) {
      const float4* wj = reinterpret_cast<const float4*>(ws + j * KK);
      float acc[POS];
#pragma unroll
      for (int e = 0; e < POS; ++e) acc[e] = 0.f;
#pragma unroll
      for (int r4 = 0; r4 < KK / 4; ++r4) {
        const float4 wv = wj[r4];
#pragma unroll
        for (int e = 0; e < POS; ++e) {
          acc[e] = fmaf(wv.x, v[e][4 * r4], acc[e]);
          acc[e] = fmaf(wv.y, v[e][4 * r4 + 1], acc[e]);
          acc[e] = fmaf(wv.z, v[e][4 * r4 + 2], acc[e]);
          acc[e] = fmaf(wv.w, v[e][4 * r4 + 3], acc[e]);
        }
      }
      // stage this j's outputs: the buffers alternate, so one barrier a j
      // keeps a buffer from being refilled before every thread wrote it out
      float* st = stage + phase * STAGE;
#pragma unroll
      for (int e = 0; e < POS; e += 4)
        *reinterpret_cast<float4*>(st + a + e) =
            make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
      __syncthreads();
      const int h = static_cast<int>((reinterpret_cast<uintptr_t>(o) >> 2) & 31);
      switch ((-h) & 3) {
        case 0: write_lines<0>(o, st, qn, h, tid); break;
        case 1: write_lines<1>(o, st, qn, h, tid); break;
        case 2: write_lines<2>(o, st, qn, h, tid); break;
        default: write_lines<3>(o, st, qn, h, tid);
      }
    }
  }
}

struct PlanePlan {
  int kk_pad, seg_len, nseg, rows_max;
  long long items;
  size_t smem;
};

// false when the shape belongs to conv3d_column
bool plane_plan(int S, int f, int fp, int nz, int kx, int ky, int kz, int npx, int npy,
                int npz, PlanePlan* p) {
  const int kk = f * kx * ky * kz;
  if (kk > 16) return false;
  p->kk_pad = kk <= 8 ? 8 : 16;
  const int pos = plane_pos(p->kk_pad), seg_max = P_THREADS * pos;
  const long long A = (long long)npy * npz;
  const long long parts = (A + seg_max - 1) / seg_max;
  const long long per = (A + parts - 1) / parts;  // even segments, no more than needed
  p->seg_len = static_cast<int>((per + pos - 1) / pos * pos);
  p->nseg = static_cast<int>((A + p->seg_len - 1) / p->seg_len);
  p->rows_max = 0;
  for (long long q0 = 0; q0 < A; q0 += p->seg_len) {
    const long long q1 = min(q0 + p->seg_len, A);
    p->rows_max = max(p->rows_max, static_cast<int>((q1 - 1) / npz - q0 / npz) + ky);
  }
  p->items = (long long)S * p->nseg * npx;
  p->smem = sizeof(float) * ((size_t)fp * p->kk_pad + 2 * p->kk_pad + 2 * (seg_max + 8) +
                             (size_t)(kx + 1) * f * p->rows_max * nz);
  return p->smem <= P_SMEM_MAX;
}

template <int KK>
cudaError_t launch_plane(const float* x, const float* w, float* out, int f, int fp,
                         int nx, int ny, int nz, int kx, int ky, int kz, int npx,
                         int npy, int npz, const PlanePlan& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_plane<KK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3d_plane<KK>,
                                                           P_THREADS, p.smem)) !=
      cudaSuccess)
    return err;
  const long long grid = min(p.items, (long long)max(per_sm, 1) * sms);
  conv3d_plane<KK><<<(unsigned)grid, P_THREADS, p.smem, stream>>>(
      x, w, out, f, fp, nx, ny, nz, kx, ky, kz, npx, npy, npz, p.seg_len, p.nseg,
      p.rows_max, p.items);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// conv3d_column: input- and FMA-bound shapes
constexpr int C_THREADS = 128;
constexpr int C_ZC = 8;        // outputs along z a thread owns
constexpr int C_KZC = 4;       // dz offsets applied per row of registers
constexpr int C_STAGE = 8192;  // input floats a stage aims at
constexpr size_t C_SMEM_MAX = 200 * 1024;

// shared-memory pitch of one x plane of a tile: hy * hz rounded up to 16
// past a multiple of 32 floats
inline int plane_pitch(int hy, int hz) {
  const int n = hy * hz;
  return n + ((16 - n % 32) + 32) % 32;
}

// KC: k (cubic) known at compile time, or 0 for k read at run time
template <int FPT, int KC>
__global__ void __launch_bounds__(C_THREADS)
conv3d_column(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, int S, int f, int fp, int nx, int ny, int nz,
              int kx_rt, int ky_rt, int kz_rt, int npx, int npy, int npz, int SB, int TX,
              int TY, int NZC, int CH, int ppitch, int tiles_x, int tiles_y,
              int tiles_z) {
  const int kx = KC ? KC : kx_rt, ky = KC ? KC : ky_rt, kz = KC ? KC : kz_rt;
  constexpr int WP = (FPT + 3) / 4 * 4;  // one offset's weights, in float4s
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hx = TX + kx - 1, hy = TY + ky - 1, hz = NZC * C_ZC + kz - 1;
  const int tpitch = hx * ppitch;  // one (channel, sample) tile
  const int k3 = kx * ky * kz;
  const int stage_w = CH * k3 * WP, stage_in = CH * SB * tpitch;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  long long b = blockIdx.x;
  const int tzi = static_cast<int>(b % tiles_z); b /= tiles_z;
  const int tyi = static_cast<int>(b % tiles_y); b /= tiles_y;
  const int txi = static_cast<int>(b % tiles_x);
  const long long s0 = (b / tiles_x) * SB;
  const int sbn = static_cast<int>(min((long long)SB, S - s0));
  const int x0 = txi * TX, y0 = tyi * TY, z0 = tzi * NZC * C_ZC;
  const int j0 = blockIdx.y * FPT, nj = min(FPT, fp - j0);
  const int ex = min(hx, nx - x0), ey = min(hy, ny - y0), ez = min(hz, nz - z0);
  const bool planes = hy == ny && hz == nz;  // a tile's x planes are whole runs
  const long long vol = (long long)nx * ny * nz;

  int t = tid;  // thread -> (sample, x, y, z chunk), z chunk fastest
  const int zc = t % NZC; t /= NZC;
  const int ty = t % TY; t /= TY;
  const int tx = t % TX;
  const int sb = t / TX;
  const bool active = sb < sbn;

  float acc[C_ZC][FPT];
#pragma unroll
  for (int e = 0; e < C_ZC; ++e)
#pragma unroll
    for (int jj = 0; jj < FPT; ++jj) acc[e][jj] = 0.f;

  const bool pairs = (hz & 1) == 0;  // rows start 8-byte aligned
  const int nst = (f + CH - 1) / CH;
  // iteration it issues stage it (channels [it*CH, it*CH + CH) into
  // buffer it & 1) and computes stage st = it - 1
  for (int it = 0; it <= nst; ++it) {
    if (it < nst) {
      const int c0 = it * CH, cn = min(CH, f - c0);
      float* wd = smem + (it & 1) * stage_w;  // [c][dx][dy][dz][WP]
      for (int e = tid; e < stage_w; e += C_THREADS) {
        const int jj = e % WP, u = e / WP, r = u % k3, c = u / k3;
        const bool ok = jj < nj && c < cn;
        cp_async4z(wd + e, ok ? w + ((long long)(j0 + jj) * f + c0 + c) * k3 + r : w, ok);
      }
      float* id = smem + 2 * stage_w + (it & 1) * stage_in;  // [c][sb][hx][ppitch]
      const int pn = hy * hz;
      for (int c = 0; c < cn; ++c)
        for (int q = 0; q < sbn; ++q) {
          float* d = id + (c * SB + q) * tpitch;
          const float* src = x + ((s0 + q) * f + c0 + c) * vol +
                             ((long long)x0 * ny + y0) * nz + z0;
          if (planes && pn % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
            const int nv = pn / 4;
            for (int e = tid; e < ex * nv; e += C_THREADS) {
              const int xx = e / nv, u = 4 * (e - xx * nv);
              cp_async16(d + xx * ppitch + u, src + (long long)xx * pn + u);
            }
          } else {
            for (int row = warp; row < ex * ey; row += C_THREADS / 32) {
              const int xx = row / ey, yy = row - xx * ey;
              const float* sr = src + ((long long)xx * ny + yy) * nz;
              float* dr = d + xx * ppitch + yy * hz;
              for (int zz = lane; zz < ez; zz += 32) cp_async4(dr + zz, sr + zz);
            }
          }
        }
    }
    cp_async_commit();
    if (it == 0) continue;
    const int st = it - 1;
    cp_async_wait<1>();  // stage st has landed
    __syncthreads();
    if (active) {
      const int cn = min(CH, f - st * CH);
      const float* wst = smem + (st & 1) * stage_w;
      const float* ist = smem + 2 * stage_w + (st & 1) * stage_in + sb * tpitch +
                         tx * ppitch + ty * hz + zc * C_ZC;
      for (int c = 0; c < cn; ++c) {
        const float* ic = ist + c * SB * tpitch;
        const float* wc = wst + c * k3 * WP;
#pragma unroll (KC > 0 ? KC : 1)
        for (int dx = 0; dx < kx; ++dx)
#pragma unroll (KC > 0 ? KC : 1)
          for (int dy = 0; dy < ky; ++dy) {
            const float* row = ic + dx * ppitch + dy * hz;
            const float* wr = wc + (dx * ky + dy) * kz * WP;
            for (int dz0 = 0; dz0 < kz; dz0 += C_KZC) {
              const int nd = min(C_KZC, kz - dz0), need = C_ZC + nd - 1;
              float rv[C_ZC + C_KZC];  // the row once, for every dz
              if (pairs) {
#pragma unroll
                for (int e = 0; e < (C_ZC + C_KZC) / 2; ++e) {
                  float2 p2 = make_float2(0.f, 0.f);
                  if (2 * e + 1 < need) p2 = reinterpret_cast<const float2*>(row + dz0)[e];
                  else if (2 * e < need) p2.x = row[dz0 + 2 * e];
                  rv[2 * e] = p2.x;
                  rv[2 * e + 1] = p2.y;
                }
              } else {
#pragma unroll
                for (int e = 0; e < C_ZC + C_KZC; ++e) rv[e] = e < need ? row[dz0 + e] : 0.f;
              }
#pragma unroll
              for (int d = 0; d < C_KZC; ++d) {
                if (d >= nd) break;
                float wv[WP];
#pragma unroll
                for (int q = 0; q < WP / 4; ++q) {
                  const float4 w4 = reinterpret_cast<const float4*>(wr + (dz0 + d) * WP)[q];
                  wv[4 * q] = w4.x;
                  wv[4 * q + 1] = w4.y;
                  wv[4 * q + 2] = w4.z;
                  wv[4 * q + 3] = w4.w;
                }
#pragma unroll
                for (int e = 0; e < C_ZC; ++e)
#pragma unroll
                  for (int jj = 0; jj < FPT; ++jj)
                    acc[e][jj] = fmaf(wv[jj], rv[e + d], acc[e][jj]);
              }
            }
          }
      }
    }
    __syncthreads();  // the next issue refills this buffer
  }

  const int ox = x0 + tx, oy = y0 + ty, oz0 = z0 + zc * C_ZC;
  if (!active || ox >= npx || oy >= npy || oz0 >= npz) return;
#pragma unroll
  for (int jj = 0; jj < FPT; ++jj) {
    if (jj >= nj) break;
    float* o = out + ((((s0 + sb) * fp + j0 + jj) * npx + ox) * (long long)npy + oy) * npz +
               oz0;
#pragma unroll
    for (int e = 0; e < C_ZC; ++e)
      if (oz0 + e < npz) o[e] = acc[e][jj];
  }
}

struct ColumnPlan {
  int fpt, sb, tx, ty, nzc, ch, ppitch, tiles_x, tiles_y, tiles_z;
  long long sgroups;
  size_t smem;
};

bool column_plan(int S, int f, int fp, int kx, int ky, int kz, int npx, int npy, int npz,
                 ColumnPlan* p) {
  p->fpt = fp <= 4 ? fp : 8;
  const int wp = (p->fpt + 3) / 4 * 4;
  const int k3 = kx * ky * kz;
  p->nzc = min((npz + C_ZC - 1) / C_ZC, 4);
  p->ty = min(npy, 8);
  p->tx = min(npx, max(1, C_THREADS / (p->nzc * p->ty)));
  p->sb = min(S, max(1, C_THREADS / (p->nzc * p->ty * p->tx)));
  for (;;) {  // shrink the tile until two stages fit
    p->ppitch = plane_pitch(p->ty + ky - 1, p->nzc * C_ZC + kz - 1);
    const long long tpitch = (long long)(p->tx + kx - 1) * p->ppitch;
    p->ch = static_cast<int>(min((long long)f, max(1LL, C_STAGE / (p->sb * tpitch))));
    p->smem = sizeof(float) * 2 * ((size_t)p->ch * k3 * wp + (size_t)p->ch * p->sb * tpitch);
    if (p->smem <= C_SMEM_MAX) break;
    if (p->sb > 1) p->sb = (p->sb + 1) / 2;
    else if (p->tx > 1) p->tx = (p->tx + 1) / 2;
    else if (p->ty > 1) p->ty = (p->ty + 1) / 2;
    else if (p->nzc > 1) p->nzc = (p->nzc + 1) / 2;
    else return false;
  }
  p->tiles_x = (npx + p->tx - 1) / p->tx;
  p->tiles_y = (npy + p->ty - 1) / p->ty;
  p->tiles_z = (npz + p->nzc * C_ZC - 1) / (p->nzc * C_ZC);
  p->sgroups = (S + p->sb - 1) / p->sb;
  return true;
}

template <int FPT, int KC>
cudaError_t launch_column(const float* x, const float* w, float* out, int S, int f,
                          int fp, int nx, int ny, int nz, int kx, int ky, int kz,
                          int npx, int npy, int npz, const ColumnPlan& p,
                          cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv3d_column<FPT, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  const long long blocks = p.sgroups * p.tiles_x * p.tiles_y * p.tiles_z;
  const int groups = (fp + FPT - 1) / FPT;
  if (blocks > 0x7fffffffLL || groups > 65535) return cudaErrorInvalidConfiguration;
  conv3d_column<FPT, KC><<<dim3((unsigned)blocks, (unsigned)groups), C_THREADS, p.smem,
                           stream>>>(x, w, out, S, f, fp, nx, ny, nz, kx, ky, kz, npx,
                                     npy, npz, p.sb, p.tx, p.ty, p.nzc, p.ch, p.ppitch,
                                     p.tiles_x, p.tiles_y, p.tiles_z);
  return cudaGetLastError();
}

template <int FPT>
cudaError_t launch_column(const float* x, const float* w, float* out, int S, int f,
                          int fp, int nx, int ny, int nz, int kx, int ky, int kz,
                          int npx, int npy, int npz, const ColumnPlan& p,
                          cudaStream_t stream) {
  if (kx == 3 && ky == 3 && kz == 3)
    return launch_column<FPT, 3>(x, w, out, S, f, fp, nx, ny, nz, kx, ky, kz, npx, npy,
                                 npz, p, stream);
  return launch_column<FPT, 0>(x, w, out, S, f, fp, nx, ny, nz, kx, ky, kz, npx, npy, npz,
                               p, stream);
}

}  // namespace

extern "C" int conv3d_f32(const float* x, const float* w, float* out, int S, int f,
                          int fp, int nx, int ny, int nz, int kx, int ky, int kz,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int npx = nx - kx + 1, npy = ny - ky + 1, npz = nz - kz + 1;
  if (S <= 0 || fp <= 0 || npx <= 0 || npy <= 0 || npz <= 0) return (int)cudaGetLastError();
  PlanePlan pp;
  if (plane_plan(S, f, fp, nz, kx, ky, kz, npx, npy, npz, &pp)) {
    if (pp.kk_pad == 8)
      return (int)launch_plane<8>(x, w, out, f, fp, nx, ny, nz, kx, ky, kz, npx, npy, npz,
                                  pp, st);
    return (int)launch_plane<16>(x, w, out, f, fp, nx, ny, nz, kx, ky, kz, npx, npy, npz,
                                 pp, st);
  }
  ColumnPlan cp;
  if (!column_plan(S, f, fp, kx, ky, kz, npx, npy, npz, &cp))
    return (int)cudaErrorInvalidConfiguration;
  switch (cp.fpt) {
    case 1:
      return (int)launch_column<1>(x, w, out, S, f, fp, nx, ny, nz, kx, ky, kz, npx, npy,
                                   npz, cp, st);
    case 2:
      return (int)launch_column<2>(x, w, out, S, f, fp, nx, ny, nz, kx, ky, kz, npx, npy,
                                   npz, cp, st);
    case 3:
      return (int)launch_column<3>(x, w, out, S, f, fp, nx, ny, nz, kx, ky, kz, npx, npy,
                                   npz, cp, st);
    case 4:
      return (int)launch_column<4>(x, w, out, S, f, fp, nx, ny, nz, kx, ky, kz, npx, npy,
                                   npz, cp, st);
    default:
      return (int)launch_column<8>(x, w, out, S, f, fp, nx, ny, nz, kx, ky, kz, npx, npy,
                                   npz, cp, st);
  }
}
