// Bilinear terrain lookup out of cached 16x16 windows, for Hopper (sm_90a).
//
// Replaces the TPU kernel monoforce_tpu/ops/interp_pallas.py::fk_interp
// (_fk_kernel, math in _fk_math).  For every (trajectory b, point p): the
// window cell index from the world query by the IEEE divide by the grid
// resolution, truncated toward zero and clipped to [0, 14]; the four taps
// at offsets (0, 16, 1, 17) for height and friction with the reference's
// weight pairing (w_cc, w_cf, w_lc, w_fl); forward-difference normals.
//
// Layout: patch (B, 512) f32 = [z(256) | mu(256)] row-major windows; wx, wy
// (B, P) f32 world queries; sxy (B, 2) f32 window corners; cst (2,) =
// [d_max, grid_res]; out (B, 5P) = [z | nx | ny | nz | mu].
//
// What bounds it on the H100.  At the shooting batch (B=4096), bytes: per
// point it reads 8 bytes of queries and writes 20 bytes of results, and
// does ~40 float operations; of the windows it needs only the words under
// the taps, but it reads them in 32-byte sectors, about twice their bytes.
// It runs at about twice the byte bound: the rest is the latency of each
// block's two dependent loads across ~3 waves of blocks.  At the fit's batch
// (B=16, 10100 launches a fit), the latency of one launch: two dependent
// loads (the query, then its taps) and the arithmetic between them.
//
// Design.  The trajectory comes from the block and the point from the
// thread: one slot of T = 32 * ceil(min(P, 256) / 32) threads a trajectory
// (larger clouds loop), blockDim = (T, G) with G = 256 / T trajectories a
// block, so there is no integer division and the slot's corner and
// constants are one broadcast load each.  Consecutive threads take
// consecutive points, so the query loads and each result plane's stores
// are coalesced; the eight tap loads a point are data-dependent but fall
// within one 2 KB window.  The index path is written with round-to-nearest
// intrinsics so that no contraction into FMA moves a query across a cell
// boundary; the normals multiply by 1/res, taken once and correctly
// rounded, in place of two divides (within 1.5 ulp of the divide, far
// inside the 1e-5 tolerance on outputs of order 1).

#include <cuda_runtime.h>

namespace {

constexpr int kBlockThreads = 256;

__global__ void __launch_bounds__(kBlockThreads)
fk_interp_kernel(const float* __restrict__ patch,
                 const float* __restrict__ wx, const float* __restrict__ wy,
                 const float* __restrict__ sxy,
                 const float* __restrict__ cst, int B, int P,
                 float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= B) return;  // the last block may hold fewer trajectories
  // every load of the first round is issued before anything waits
  const float d_max = cst[0];
  const float res = cst[1];
  const int sx = (int)sxy[2 * b];
  const int sy = (int)sxy[2 * b + 1];
  const float* qx = wx + (size_t)b * P;
  const float* qy = wy + (size_t)b * P;
  const float* win = patch + (size_t)b * 512;
  float* o = out + (size_t)b * 5 * P;
  int p = threadIdx.x;
  float x = 0.0f, y = 0.0f;
  if (p < P) {
    x = qx[p];
    y = qy[p];
  }
  const float inv_res = __frcp_rn(res);

  while (p < P) {
    const float fxq = __fdiv_rn(__fadd_rn(x, d_max), res);
    const float fyq = __fdiv_rn(__fadd_rn(y, d_max), res);
    const int xi = (int)fxq;  // truncation toward zero, like astype(int32)
    const int yi = (int)fyq;
    const float xf = fxq - (float)xi;
    const float yf = fyq - (float)yi;
    const int xl = min(max(xi - sx, 0), 14);
    const int yl = min(max(yi - sy, 0), 14);
    const float* zp = win + xl * 16 + yl;
    const float* fp = zp + 256;

    const float w_cc = (1.0f - xf) * (1.0f - yf);
    const float w_cf = (1.0f - xf) * yf;
    const float w_lc = xf * (1.0f - yf);
    const float w_fl = xf * yf;
    const float t0 = zp[0], t1 = zp[16], t2 = zp[1], t3 = zp[17];
    const float z = w_cc * t0 + w_cf * t1 + w_lc * t2 + w_fl * t3;
    const float mu =
        w_cc * fp[0] + w_cf * fp[16] + w_lc * fp[1] + w_fl * fp[17];
    const float dz_dx = (t1 - t0) * inv_res;
    const float dz_dy = (t2 - t0) * inv_res;
    const float inv = rsqrtf(dz_dx * dz_dx + dz_dy * dz_dy + 1.0f);

    o[p] = z;
    o[P + p] = -dz_dx * inv;
    o[2 * P + p] = -dz_dy * inv;
    o[3 * P + p] = inv;
    o[4 * P + p] = mu;
    p += blockDim.x;  // clouds past 256 points: the next round
    if (p < P) {
      x = qx[p];
      y = qy[p];
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fk_interp_launch(const float* patch, const float* wx,
                                const float* wy, const float* sxy,
                                const float* cst, int B, int P, float* out,
                                cudaStream_t stream) {
  if (B == 0 || P == 0) return 0;
  const int per = P < 256 ? P : 256;
  const int T = 32 * ((per + 31) / 32);  // threads a slot
  const int G = kBlockThreads / T;       // slots a block
  const dim3 block(T, G);
  fk_interp_kernel<<<(unsigned)((B + G - 1) / G), block, 0, stream>>>(
      patch, wx, wy, sxy, cst, B, P, out);
  return (int)cudaGetLastError();
}
