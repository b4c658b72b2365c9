// Backward pass of the bilinear terrain lookup, for Hopper (sm_90a).
//
// Replaces the backward of the TPU kernel
// monoforce_tpu/ops/interp_pallas.py::fk_interp (its custom VJP _fk_bwd,
// which JAX leaves to jax.vjp of the plain twin _fk_xla).  Given the
// cotangent g (B, 5P) of the output [z | nx | ny | nz | mu], it gives the
// cotangents of the window patch (B, 512), of the queries wx and wy (B, P).
//
// The math, per point (the forward is fk_interp.cu):
//   xf = (wx + d_max) / res - trunc(...), likewise yf; the truncations carry
//   no gradient, so d xf / d wx = 1 / res.
//   z = w_cc t0 + w_cf t1 + w_lc t2 + w_fl t3 over the taps at offsets
//   (0, 16, 1, 17), with the reference's weight pairing
//   w_cc = (1-xf)(1-yf), w_cf = (1-xf) yf, w_lc = xf (1-yf), w_fl = xf yf;
//   mu likewise over the friction taps.
//   a = (t1 - t0) / res, b = (t2 - t0) / res, inv = rsqrt(a^2 + b^2 + 1),
//   n = (-a inv, -b inv, inv): the normals depend on taps 0, 1 and 2 only.
//   With s = inv^3 (g_nx a + g_ny b - g_nz):
//     d/da = -g_nx inv + a s,  d/db = -g_ny inv + b s.
//
// What bounds it on the H100.  At the shooting batch (B=4096), bytes in
// principle: per point it reads 8 bytes of queries and 20 of cotangent and
// writes 8; per trajectory it writes the whole 2 KB d patch row (zeros
// included); ~86 float operations a point.  In practice the chain of each
// block (two dependent loads, the IEEE divides of the index, the cell sums
// in shared memory, a barrier, the row's store) across ~3 waves of blocks
// sets the time, about twice the byte bound.  At the fit's batch (B=16,
// 10100 launches a fit), the latency of one launch: a few thousand points,
// so the time is the launch plus one block's chain.
//
// Design.  One slot of T = 32 * ceil(min(P, 256) / 32) threads a
// trajectory, one thread a point, so every cloud up to 256 points runs in
// one round (larger clouds loop); blockDim = (T, G) with G = 256 / T
// trajectories a block, so small clouds share a block and a large batch is
// not a grid of thousands of tiny blocks.  Every load of the first round
// (constants, corner, query, cotangent) is issued before anything waits;
// the tap loads follow the index.  Each warp owns one 512-word row of
// shared memory for its cell sums (16 KB a block), zeroed by the warp
// itself and read back with 16-byte accesses.  Contact points lie along
// the tracks, so neighbouring points often share a cell: the lanes of a
// warp with equal cells (__match_any_sync on the index) add their eight
// contributions in registers along a fixed tree, and the group's lowest
// lane alone adds them to its warp's row.  Float atomics on shared memory
// are compare-and-swap loops on this card, so the adds are plain loads and
// stores: the lanes of one add hit distinct words, and the four tap
// offsets go in four steps ordered by __syncwarp, since one lane's tap at
// idx + 1 may be another's at idx.  At the end each trajectory's rows are
// added in warp order and the d patch row is written once with 16-byte
// stores.  So the order of every sum is
// fixed by the inputs and d patch is the same from run to run.  The index
// path keeps round-to-nearest intrinsics in the plain version's order, so
// that each point takes the forward pass's cell; off that path 1/res is
// taken once, correctly rounded, and multiplied by.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockThreads = 256;
constexpr int kMaxWarps = kBlockThreads / 32;  // one cell-sum row each
constexpr unsigned kFull = 0xffffffffu;

// Adds v over the lanes of `grp` (the lanes of this warp with this lane's
// cell) along a fixed tree in rank order; the group's lowest lane ends with
// the sum.  `widest` is the largest group of the warp.
template <int N>
__device__ __forceinline__ void group_sum(float (&v)[N], unsigned grp,
                                          int lane, int widest) {
  const int rank = __popc(grp & ((1u << lane) - 1u));
  unsigned r = grp & ~((2u << lane) - 1u);  // the members above this lane
  for (int s = 1; s < widest; s <<= 1) {
    // r has lost the s - 1 nearest members: its lowest is s ranks above
    const bool take = (rank & (2 * s - 1)) == 0 && r != 0u;
    const int src = take ? __ffs(r) - 1 : lane;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float o = __shfl_sync(kFull, v[k], src);
      if (take) v[k] += o;
    }
    for (int j = 0; j < s; ++j) r &= r - 1u;
  }
}

// A point's inputs from device memory: its query and the cotangent of its
// five outputs (zeros off the cloud).
struct PointIn {
  float qx, qy, g[5];
};

__device__ __forceinline__ PointIn load_point(const float* __restrict__ wx,
                                              const float* __restrict__ wy,
                                              const float* __restrict__ gb,
                                              size_t t, int p, int P,
                                              bool on) {
  PointIn in = {0.0f, 0.0f, {0.0f, 0.0f, 0.0f, 0.0f, 0.0f}};
  if (on) {
    in.qx = wx[t];
    in.qy = wy[t];
#pragma unroll
    for (int k = 0; k < 5; ++k) in.g[k] = gb[k * P + p];
  }
  return in;
}

__global__ void __launch_bounds__(kBlockThreads)
fk_interp_bwd_kernel(const float* __restrict__ patch,
                     const float* __restrict__ wx,
                     const float* __restrict__ wy,
                     const float* __restrict__ sxy,
                     const float* __restrict__ cst,
                     const float* __restrict__ g, int B, int P,
                     float* __restrict__ dpatch, float* __restrict__ dwx,
                     float* __restrict__ dwy) {
  __shared__ float4 rows[kMaxWarps * 128];
  const int T = blockDim.x;
  const int tid = threadIdx.y * T + threadIdx.x;
  const int lane = tid & 31;
  const int b = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = b < B;  // the last block may hold fewer trajectories

  // every load of the first round is issued before anything waits: the
  // constants, the corner, the query and its cotangent
  const float d_max = cst[0];
  const float res = cst[1];
  int sx = 0, sy = 0;
  if (live) {
    sx = (int)sxy[2 * b];
    sy = (int)sxy[2 * b + 1];
  }
  const float* win = patch + (size_t)b * 512;
  const float* gb = g + (size_t)b * 5 * P;
  PointIn in = load_point(wx, wy, gb, (size_t)b * P + threadIdx.x,
                          threadIdx.x, P, live && (int)threadIdx.x < P);
  // each warp zeroes its own row, so no block barrier is needed yet
  float4* row4 = rows + (tid >> 5) * 128;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    row4[lane + 32 * k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float* row = reinterpret_cast<float*>(row4);
  const float inv_res = __frcp_rn(res);
  __syncwarp();

  for (int base = 0;;) {  // whole warps take every round
    const int p = base + threadIdx.x;
    const bool on = live && p < P;
    const size_t t = (size_t)b * P + p;
    const float gz = in.g[0], gnx = in.g[1], gny = in.g[2], gnz = in.g[3],
                gmu = in.g[4];
    const float fxq = __fdiv_rn(__fadd_rn(in.qx, d_max), res);
    const float fyq = __fdiv_rn(__fadd_rn(in.qy, d_max), res);
    const int xi = (int)fxq;  // truncation toward zero, as in the forward
    const int yi = (int)fyq;
    const float xf = fxq - (float)xi;
    const float yf = fyq - (float)yi;
    const int idx = min(max(xi - sx, 0), 14) * 16 + min(max(yi - sy, 0), 14);
    float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f, t3 = 0.0f;
    float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f, f3 = 0.0f;
    if (on) {  // one address, constant offsets
      const float* w = win + idx;
      t0 = w[0];
      t1 = w[16];
      t2 = w[1];
      t3 = w[17];
      f0 = w[256];
      f1 = w[256 + 16];
      f2 = w[256 + 1];
      f3 = w[256 + 17];
    }

    const float w_cc = (1.0f - xf) * (1.0f - yf);
    const float w_cf = (1.0f - xf) * yf;
    const float w_lc = xf * (1.0f - yf);
    const float w_fl = xf * yf;

    // normals: through a = (t1 - t0) / res and c = (t2 - t0) / res
    const float a = (t1 - t0) * inv_res;
    const float c = (t2 - t0) * inv_res;
    const float inv = rsqrtf(a * a + c * c + 1.0f);
    const float s = inv * inv * inv * (gnx * a + gny * c - gnz);
    const float da = (a * s - gnx * inv) * inv_res;
    const float dc = (c * s - gny * inv) * inv_res;

    // d/dxf and d/dyf of the bilinear sums, then d xf / d wx = 1 / res
    if (on) {
      const float dzx = (1.0f - yf) * (t2 - t0) + yf * (t3 - t1);
      const float dmx = (1.0f - yf) * (f2 - f0) + yf * (f3 - f1);
      const float dzy = (1.0f - xf) * (t1 - t0) + xf * (t3 - t2);
      const float dmy = (1.0f - xf) * (f1 - f0) + xf * (f3 - f2);
      dwx[t] = (gz * dzx + gmu * dmx) * inv_res;
      dwy[t] = (gz * dzy + gmu * dmy) * inv_res;
    }

    // the cotangents of the taps at idx, idx + 16, idx + 1, idx + 17 of the
    // z plane, then of the friction plane
    float v[8] = {gz * w_cc - da - dc, gz * w_cf + da, gz * w_lc + dc,
                  gz * w_fl, gmu * w_cc, gmu * w_cf, gmu * w_lc, gmu * w_fl};
    // lanes off the cloud get keys of their own (no cell is >= 256)
    const unsigned grp = __match_any_sync(kFull, on ? idx : 256 + lane);
    const int widest = (int)__reduce_max_sync(kFull, (unsigned)__popc(grp));
    if (widest > 1) group_sum(v, grp, lane, widest);
    // the group's lowest lane adds the sums to its warp's row, one tap
    // offset a step (the design note says why)
    const bool leader = on && (grp & ((1u << lane) - 1u)) == 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float* at = row + idx + (k & 1) * 16 + (k >> 1);  // taps 0, 16, 1, 17
      if (leader) {
        at[0] += v[k];
        at[256] += v[4 + k];
      }
      __syncwarp();
    }

    base += T;
    if (base >= P) break;
    in = load_point(wx, wy, gb, t + T, p + T, P, live && p + T < P);
  }
  __syncthreads();
  if (!live) return;
  // this trajectory's warps' rows, added in warp order
  const int warps = T >> 5;
  const float4* mine = rows + threadIdx.y * warps * 128;
  float4* out = reinterpret_cast<float4*>(dpatch) + (size_t)b * 128;
  for (int i = threadIdx.x; i < 128; i += T) {
    float4 acc = mine[i];
    for (int w = 1; w < warps; ++w) {
      const float4 r = mine[w * 128 + i];
      acc.x += r.x;
      acc.y += r.y;
      acc.z += r.z;
      acc.w += r.w;
    }
    out[i] = acc;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  dpatch
// must be 16-byte aligned (the wrapper allocates it).
extern "C" int fk_interp_bwd_launch(const float* patch, const float* wx,
                                    const float* wy, const float* sxy,
                                    const float* cst, const float* g, int B,
                                    int P, float* dpatch, float* dwx,
                                    float* dwy, cudaStream_t stream) {
  if (B == 0) return 0;
  const int per = P < 256 ? P : 256;
  const int T = per > 32 ? 32 * ((per + 31) / 32) : 32;  // threads a slot
  const int G = kBlockThreads / T;                      // slots a block
  const unsigned blocks = (unsigned)((B + G - 1) / G);
  const dim3 block(T, G);
  fk_interp_bwd_kernel<<<blocks, block, 0, stream>>>(
      patch, wx, wy, sxy, cst, g, B, P, dpatch, dwx, dwy);
  return (int)cudaGetLastError();
}
