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
// Bound on the H100: bytes.  Per point it reads 8 bytes of queries and
// writes 20 bytes of results, and does ~40 flops; the windows (2 KB per
// trajectory) are read once per trajectory at most and then hit in L1/L2.
// Design: one thread per (b, p), consecutive threads on consecutive points,
// so the query loads and each result plane's stores are coalesced; the 8
// tap loads per thread are data-dependent but fall within one 2 KB window.
// The index path is written with round-to-nearest intrinsics so that no
// contraction into FMA moves a query across a cell boundary.

#include <cuda_runtime.h>

namespace {

__global__ void fk_interp_kernel(const float* __restrict__ patch,
                                 const float* __restrict__ wx,
                                 const float* __restrict__ wy,
                                 const float* __restrict__ sxy,
                                 const float* __restrict__ cst, int B, int P,
                                 float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * P) return;
  const int b = (int)(t / P);
  const int p = (int)(t - (long long)b * P);
  const float d_max = cst[0];
  const float res = cst[1];

  const float fxq = __fdiv_rn(__fadd_rn(wx[t], d_max), res);
  const float fyq = __fdiv_rn(__fadd_rn(wy[t], d_max), res);
  const int xi = (int)fxq;  // truncation toward zero, like astype(int32)
  const int yi = (int)fyq;
  const float xf = fxq - (float)xi;
  const float yf = fyq - (float)yi;
  const int sx = (int)sxy[2 * b];
  const int sy = (int)sxy[2 * b + 1];
  const int xl = min(max(xi - sx, 0), 14);
  const int yl = min(max(yi - sy, 0), 14);
  const float* zp = patch + (size_t)b * 512 + xl * 16 + yl;
  const float* fp = zp + 256;

  const float w_cc = (1.0f - xf) * (1.0f - yf);
  const float w_cf = (1.0f - xf) * yf;
  const float w_lc = xf * (1.0f - yf);
  const float w_fl = xf * yf;
  const float t0 = zp[0], t1 = zp[16], t2 = zp[1], t3 = zp[17];
  const float z = w_cc * t0 + w_cf * t1 + w_lc * t2 + w_fl * t3;
  const float mu = w_cc * fp[0] + w_cf * fp[16] + w_lc * fp[1] + w_fl * fp[17];
  const float dz_dx = (t1 - t0) / res;
  const float dz_dy = (t2 - t0) / res;
  const float inv = rsqrtf(dz_dx * dz_dx + dz_dy * dz_dy + 1.0f);

  float* o = out + (size_t)b * 5 * P + p;
  o[0] = z;
  o[P] = -dz_dx * inv;
  o[2 * P] = -dz_dy * inv;
  o[3 * P] = inv;
  o[4 * P] = mu;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fk_interp_launch(const float* patch, const float* wx,
                                const float* wy, const float* sxy,
                                const float* cst, int B, int P, float* out,
                                cudaStream_t stream) {
  const long long n = (long long)B * P;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  fk_interp_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      patch, wx, wy, sxy, cst, B, P, out);
  return (int)cudaGetLastError();
}
