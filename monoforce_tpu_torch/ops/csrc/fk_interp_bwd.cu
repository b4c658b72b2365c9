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
// Bound on the H100: bytes.  Per point it reads 8 bytes of queries and 20
// of cotangent and writes 8; per trajectory it writes the whole 2 KB d patch
// row (zeros included).  It does ~80 flops per point.  Design: one block per
// trajectory; the block accumulates its d patch row in shared memory with
// shared-memory atomics (eight per point), then writes the row once with
// coalesced stores.  Each point writes its own d wx and d wy.  Points that
// share a cell add in the order the atomics land, so d patch differs from a
// sequential sum in the last bits and from run to run.  The index path is
// written with round-to-nearest intrinsics, as in the forward kernel, so
// that each point takes the same cell as the forward pass.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
fk_interp_bwd_kernel(const float* __restrict__ patch,
                     const float* __restrict__ wx,
                     const float* __restrict__ wy,
                     const float* __restrict__ sxy,
                     const float* __restrict__ cst,
                     const float* __restrict__ g, int P,
                     float* __restrict__ dpatch, float* __restrict__ dwx,
                     float* __restrict__ dwy) {
  __shared__ float acc[512];
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < 512; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  const float d_max = cst[0];
  const float res = cst[1];
  const int sx = (int)sxy[2 * b];
  const int sy = (int)sxy[2 * b + 1];
  const float* win = patch + (size_t)b * 512;
  const float* gb = g + (size_t)b * 5 * P;

  for (int p = threadIdx.x; p < P; p += kThreads) {
    const size_t t = (size_t)b * P + p;
    const float fxq = __fdiv_rn(__fadd_rn(wx[t], d_max), res);
    const float fyq = __fdiv_rn(__fadd_rn(wy[t], d_max), res);
    const int xi = (int)fxq;  // truncation toward zero, as in the forward
    const int yi = (int)fyq;
    const float xf = fxq - (float)xi;
    const float yf = fyq - (float)yi;
    const int idx = min(max(xi - sx, 0), 14) * 16 + min(max(yi - sy, 0), 14);
    const float t0 = win[idx], t1 = win[idx + 16];
    const float t2 = win[idx + 1], t3 = win[idx + 17];
    const float f0 = win[256 + idx], f1 = win[256 + idx + 16];
    const float f2 = win[256 + idx + 1], f3 = win[256 + idx + 17];

    const float gz = gb[p], gnx = gb[P + p], gny = gb[2 * P + p];
    const float gnz = gb[3 * P + p], gmu = gb[4 * P + p];

    const float w_cc = (1.0f - xf) * (1.0f - yf);
    const float w_cf = (1.0f - xf) * yf;
    const float w_lc = xf * (1.0f - yf);
    const float w_fl = xf * yf;

    // normals: through a = (t1 - t0) / res and b = (t2 - t0) / res
    const float a = (t1 - t0) / res;
    const float c = (t2 - t0) / res;
    const float inv = rsqrtf(a * a + c * c + 1.0f);
    const float s = inv * inv * inv * (gnx * a + gny * c - gnz);
    const float da = (a * s - gnx * inv) / res;
    const float dc = (c * s - gny * inv) / res;

    atomicAdd(&acc[idx], gz * w_cc - da - dc);
    atomicAdd(&acc[idx + 16], gz * w_cf + da);
    atomicAdd(&acc[idx + 1], gz * w_lc + dc);
    atomicAdd(&acc[idx + 17], gz * w_fl);
    atomicAdd(&acc[256 + idx], gmu * w_cc);
    atomicAdd(&acc[256 + idx + 16], gmu * w_cf);
    atomicAdd(&acc[256 + idx + 1], gmu * w_lc);
    atomicAdd(&acc[256 + idx + 17], gmu * w_fl);

    // d/dxf and d/dyf of the bilinear sums, then d xf / d wx = 1 / res
    const float dzx = (1.0f - yf) * (t2 - t0) + yf * (t3 - t1);
    const float dmx = (1.0f - yf) * (f2 - f0) + yf * (f3 - f1);
    const float dzy = (1.0f - xf) * (t1 - t0) + xf * (t3 - t2);
    const float dmy = (1.0f - xf) * (f1 - f0) + xf * (f3 - f2);
    dwx[t] = (gz * dzx + gmu * dmx) / res;
    dwy[t] = (gz * dzy + gmu * dmy) / res;
  }
  __syncthreads();
  float* out = dpatch + (size_t)b * 512;
  for (int i = threadIdx.x; i < 512; i += kThreads) out[i] = acc[i];
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fk_interp_bwd_launch(const float* patch, const float* wx,
                                    const float* wy, const float* sxy,
                                    const float* cst, const float* g, int B,
                                    int P, float* dpatch, float* dwx,
                                    float* dwy, cudaStream_t stream) {
  if (B == 0) return 0;
  fk_interp_bwd_kernel<<<(unsigned)B, kThreads, 0, stream>>>(
      patch, wx, wy, sxy, cst, g, P, dpatch, dwx, dwy);
  return (int)cudaGetLastError();
}
