// The per-point physics of one rollout step, reduced per trajectory, for
// Hopper (sm_90a).
//
// Replaces every step kernel of monoforce_tpu/ops/fk_step_pallas.py, as one
// template over the window format:
//   fk_step_pair_zu, fk_step_pair3_zu -> format kZu     (bf16 z-pair words,
//                                                         mu == 1)
//   fk_step_pair3_muq                 -> format kMuq    (z-pair words + one
//                                                         u8 friction quad)
//   fk_step_pair                      -> format kPairMu (bf16 [z | mu] words,
//                                                         nearest-cell mu)
//   fk_step_pair3                     -> format kPair3  (bf16 [z | mu] words,
//                                                         bilinear mu)
//   fk_step_packed                    -> format kPacked (bf16 [z | mu] words,
//                                                         bilinear mu)
//   fk_step                           -> format kExact  (f32 [z(256) |
//                                                         mu(256)] windows)
// The first four follow _step_math_pair (:474-682): the cell index from a
// multiply by 1/res, and the spring std from the sum and the sum of squares.
// kPacked and kExact follow _step_math (:128-274): the cell index from the
// IEEE divide by res, and the spring std in two passes (the mean, then the
// sum of squared deviations), each point's spring force held in shared
// memory between the passes.
// The TPU's two-trajectories-per-register packing, its lane gathers, its
// ones-matmul reductions and its ghost points are layout, not semantics:
// here one warp owns one trajectory and its lanes stride over the P real
// points.  Dropping the ghosts changes one term: on the TPU each ghost lane
// adds sqrt(1e-30) = 1e-15 N to the spring sum (and 1e-30 to the sum of
// squares), which is below float32 resolution of any real statistic.
//
// Per trajectory: state (18) = [x(3) v(3) R(9, row-major) omega(3)], track
// velocities tv (n_k), window corner sxy (2), window words (256 or 512
// 32-bit words).  Points pts (7, P) = [px, py, pz, drive_mask_0..3].
// Output (8) = [ax, ay, az, aw0, aw1, aw2, spring_std, n_contacts].
//
// Bound on the H100: operations.  A trajectory reads 1 or 2 KB of window
// words and ~100 bytes of state, tv and corners, and does ~150-170 flops
// per point (P <= 256), more than the 67 TFLOP/s float32 rate takes for the
// bytes moved.  Design: each warp copies its window into shared memory with
// coalesced loads, so the 2-8 data-dependent tap reads per point hit shared
// memory; the block stages the point planes once for its warps.  The
// per-point work runs twice: once for the contact count n_cp (the force
// normalisation needs it), once for the forces; recomputing is cheaper than
// holding ~15 values per point.  The reductions are warp shuffles.  The
// index path (world point -> cell) is written with round-to-nearest
// intrinsics so that no FMA contraction moves a point across a cell
// boundary away from the plain PyTorch version; the rest may contract.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // trajectories per block

enum Format { kZu = 0, kMuq = 1, kPairMu = 2, kPacked = 3, kExact = 4,
              kPair3 = 5 };

template <int FMT>
struct Traits {
  // window words per trajectory
  static constexpr int kWords = (FMT == kMuq || FMT == kExact) ? 512 : 256;
  // _step_math's formats: IEEE divide in the index path, two-pass std
  static constexpr bool kDivide = FMT == kPacked || FMT == kExact;
  // [z | mu] words: four taps give z (high halves) and mu (low halves)
  static constexpr bool kZMuWords =
      FMT == kPairMu || FMT == kPacked || FMT == kPair3;
};

// cst layout of pack_consts (monoforce_tpu/ops/fk_step_pallas.py:68-71)
enum {
  C_DMAX, C_RES, C_STIFF, C_DAMP, C_MASS, C_G, C_GD0, C_GD1, C_GD2, C_OMAX,
  C_NREAL, C_I00, C_I01, C_I02, C_I11, C_I12, C_I22, C_DT
};

__device__ __forceinline__ float hi_half(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ float lo_half(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dot of a rotation row with a body point, rounded op by op
__device__ __forceinline__ float rot_rn(float a, float b, float c, float px,
                                        float py, float pz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)),
                   __fmul_rn(c, pz));
}

struct Point {
  float rx, ry, rz, vx, vy, vz, nx, ny, nz, dh, mu, contact;
};

template <int FMT>
__global__ void __launch_bounds__(kWarps * 32)
fk_step_kernel(const float* __restrict__ cst,
               const uint32_t* __restrict__ patch,
               const float* __restrict__ state, const float* __restrict__ tv,
               const float* __restrict__ sxy, const float* __restrict__ pts,
               int B, int P, int n_k, float* __restrict__ out) {
  constexpr int W = Traits<FMT>::kWords;
  constexpr bool kDivide = Traits<FMT>::kDivide;
  extern __shared__ float smem[];
  float* s_pts = smem;                                            // (7, P)
  uint32_t* s_win = reinterpret_cast<uint32_t*>(smem + 7 * P);    // (kWarps, W)
  // each point's spring force for the two-pass std (kDivide formats only)
  float* s_spr = smem + 7 * P + kWarps * W;                       // (kWarps, P)

  for (int i = threadIdx.x; i < 7 * P; i += blockDim.x) s_pts[i] = pts[i];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  uint32_t* win = s_win + warp * W;
  float* spr = s_spr + warp * P;
  if (b < B) {
    const uint32_t* src = patch + (size_t)b * W;
    for (int i = lane; i < W; i += 32) win[i] = src[i];
  }
  __syncthreads();
  if (b >= B) return;

  const float d_max = cst[C_DMAX], res = cst[C_RES];
  const float stiff = cst[C_STIFF], damp = cst[C_DAMP];
  const float m = cst[C_MASS], g = cst[C_G];
  const float inv_res = 1.0f / res;  // the pair kernels' reciprocal
  const float mg = m * g;

  const float* s = state + (size_t)b * 18;
  const float x0 = s[0], x1 = s[1], x2 = s[2];
  const float v0 = s[3], v1 = s[4], v2 = s[5];
  const float r00 = s[6], r01 = s[7], r02 = s[8];
  const float r10 = s[9], r11 = s[10], r12 = s[11];
  const float r20 = s[12], r21 = s[13], r22 = s[14];
  const float w0 = s[15], w1 = s[16], w2 = s[17];
  const int sx = (int)sxy[2 * b];
  const int sy = (int)sxy[2 * b + 1];

  auto eval = [&](int p) {
    Point q;
    const float px = s_pts[p], py = s_pts[P + p], pz = s_pts[2 * P + p];
    q.rx = rot_rn(r00, r01, r02, px, py, pz);
    q.ry = rot_rn(r10, r11, r12, px, py, pz);
    q.rz = rot_rn(r20, r21, r22, px, py, pz);
    const float wx = __fadd_rn(q.rx, x0);
    const float wy = __fadd_rn(q.ry, x1);
    const float wz = __fadd_rn(q.rz, x2);
    q.vx = v0 + w1 * q.rz - w2 * q.ry;
    q.vy = v1 + w2 * q.rx - w0 * q.rz;
    q.vz = v2 + w0 * q.ry - w1 * q.rx;

    const float fxq = kDivide ? __fdiv_rn(__fadd_rn(wx, d_max), res)
                              : __fmul_rn(__fadd_rn(wx, d_max), inv_res);
    const float fyq = kDivide ? __fdiv_rn(__fadd_rn(wy, d_max), res)
                              : __fmul_rn(__fadd_rn(wy, d_max), inv_res);
    const int xi = (int)fxq;  // truncation toward zero
    const int yi = (int)fyq;
    const float xf = fxq - (float)xi;
    const float yf = fyq - (float)yi;
    const int idx = min(max(xi - sx, 0), 14) * 16 + min(max(yi - sy, 0), 14);
    const float w_cc = (1.0f - xf) * (1.0f - yf);
    const float w_cf = (1.0f - xf) * yf;
    const float w_lc = xf * (1.0f - yf);
    const float w_fl = xf * yf;

    float t0, t1, t2, t3;
    if (Traits<FMT>::kZMuWords) {
      // [z | mu] words: z from the four taps' high halves; mu from the
      // tap-0 cell's low half (kPairMu) or bilinear over the low halves
      const uint32_t c0 = win[idx], c1 = win[idx + 16];
      const uint32_t c2 = win[idx + 1], c3 = win[idx + 17];
      t0 = hi_half(c0);
      t1 = hi_half(c1);
      t2 = hi_half(c2);
      t3 = hi_half(c3);
      q.mu = FMT == kPairMu
                 ? lo_half(c0)
                 : w_cc * lo_half(c0) + w_cf * lo_half(c1) +
                       w_lc * lo_half(c2) + w_fl * lo_half(c3);
    } else if (FMT == kExact) {
      // f32 planes: z in words 0-255, mu in 256-511
      const float* wf = reinterpret_cast<const float*>(win) + idx;
      t0 = wf[0];
      t1 = wf[16];
      t2 = wf[1];
      t3 = wf[17];
      q.mu = w_cc * wf[256] + w_cf * wf[272] + w_lc * wf[257] +
             w_fl * wf[273];
    } else {
      // z-pair words [z(i,j) | z(i,j+1)]: two reads give all four taps
      const uint32_t a = win[idx], c = win[idx + 16];
      t0 = hi_half(a);
      t1 = hi_half(c);
      t2 = lo_half(a);
      t3 = lo_half(c);
      q.mu = 1.0f;
      if (FMT == kMuq) {
        // u8 quad of this cell's four friction taps, scale 1/64
        const uint32_t mq = win[256 + idx];
        const float m0 = (float)((mq >> 24) & 255u);
        const float m1 = (float)((mq >> 16) & 255u);
        const float m2 = (float)((mq >> 8) & 255u);
        const float m3 = (float)(mq & 255u);
        q.mu = (w_cc * m0 + w_cf * m1 + w_lc * m2 + w_fl * m3) *
               (1.0f / 64.0f);
      }
    }
    const float z = w_cc * t0 + w_cf * t1 + w_lc * t2 + w_fl * t3;
    const float dz_dx = (t1 - t0) / res;
    const float dz_dy = (t2 - t0) / res;
    const float ninv = rsqrtf(dz_dx * dz_dx + dz_dy * dz_dy + 1.0f);
    q.nx = -dz_dx * ninv;
    q.ny = -dz_dy * ninv;
    q.nz = ninv;
    q.dh = wz - z;
    // exp overflows to inf far above the terrain: contact is then 0
    q.contact = 1.0f / (1.0f + expf(10.0f * q.dh));
    return q;
  };

  // round 1: the contact count that normalises the spring forces
  float part = 0.0f;
  for (int p = lane; p < P; p += 32) part += eval(p).contact;
  const float n_cp = warp_sum(part);
  const float n_div = n_cp > 0.0f ? n_cp : 1.0f;  // exactly-zero guard only

  // round 2: forces, torques and the spring statistics
  const float tn = rsqrtf(fmaxf(r00 * r00 + r10 * r10 + r20 * r20, 1e-12f));
  const float tx = r00 * tn, ty = r10 * tn, tz = r20 * tn;
  float tvk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) tvk[k] = k < n_k ? tv[(size_t)b * n_k + k] : 0.0f;

  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int p = lane; p < P; p += 32) {
    const Point q = eval(p);
    const float vn = q.vx * q.nx + q.vy * q.ny + q.vz * q.nz;
    const float scale = -(stiff * q.dh + damp * vn);
    const float cs = scale * q.contact / n_div;
    const float fsx = clampf(cs * q.nx, -mg, mg);
    const float fsy = clampf(cs * q.ny, -mg, mg);
    const float fsz = clampf(cs * q.nz, -mg, mg);
    const float spring = sqrtf(fsx * fsx + fsy * fsy + fsz * fsz + 1e-30f);
    if (kDivide) spr[p] = spring;

    float cmd = tvk[0] * s_pts[3 * P + p];
#pragma unroll
    for (int k = 1; k < 4; ++k)
      if (k < n_k) cmd += tvk[k] * s_pts[(3 + k) * P + p];
    float sfx = cmd * tx - q.vx;
    float sfy = cmd * ty - q.vy;
    float sfz = cmd * tz - q.vz;
    if (FMT != kZu) {
      sfx *= q.mu;
      sfy *= q.mu;
      sfz *= q.mu;
    }
    const float sn = sfx * q.nx + sfy * q.ny + sfz * q.nz;
    const float fx = fsx + clampf(spring * (sfx - sn * q.nx), -mg, mg);
    const float fy = fsy + clampf(spring * (sfy - sn * q.ny), -mg, mg);
    const float fz = fsz + clampf(spring * (sfz - sn * q.nz), -mg, mg);
    acc[0] += q.ry * fz - q.rz * fy;
    acc[1] += q.rz * fx - q.rx * fz;
    acc[2] += q.rx * fy - q.ry * fx;
    acc[3] += fx;
    acc[4] += fy;
    acc[5] += fz;
    acc[6] += spring;
    acc[7] += spring * spring;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = warp_sum(acc[i]);

  const float n_real = cst[C_NREAL];
  const float s_mean = acc[6] / n_real;
  float s_var;
  if (kDivide) {
    // second pass: each lane reads back the spring forces it wrote
    float dev = 0.0f;
    for (int p = lane; p < P; p += 32) {
      const float d = spr[p] - s_mean;
      dev += d * d;
    }
    s_var = warp_sum(dev) / n_real;
  } else {
    s_var = fmaxf(acc[7] / n_real - s_mean * s_mean, 0.0f);
  }

  if (lane == 0) {
    const float om = cst[C_OMAX];
    const float i00 = cst[C_I00], i01 = cst[C_I01], i02 = cst[C_I02];
    const float i11 = cst[C_I11], i12 = cst[C_I12], i22 = cst[C_I22];
    const float tq0 = acc[0], tq1 = acc[1], tq2 = acc[2];
    float* o = out + (size_t)b * 8;
    o[0] = (m * g * cst[C_GD0] + acc[3]) / m;
    o[1] = (m * g * cst[C_GD1] + acc[4]) / m;
    o[2] = (m * g * cst[C_GD2] + acc[5]) / m;
    o[3] = clampf(i00 * tq0 + i01 * tq1 + i02 * tq2, -om, om);
    o[4] = clampf(i01 * tq0 + i11 * tq1 + i12 * tq2, -om, om);
    o[5] = clampf(i02 * tq0 + i12 * tq1 + i22 * tq2, -om, om);
    o[6] = sqrtf(s_var + 1e-30f);
    o[7] = n_cp;
  }
}

template <int FMT>
int launch(const float* cst, const uint32_t* patch, const float* state,
           const float* tv, const float* sxy, const float* pts, int B, int P,
           int n_k, float* out, cudaStream_t stream) {
  constexpr int W = Traits<FMT>::kWords;
  const int spr = Traits<FMT>::kDivide ? kWarps * P : 0;
  const size_t smem = (size_t)(7 * P + kWarps * W + spr) * sizeof(float);
  const unsigned blocks = (unsigned)((B + kWarps - 1) / kWarps);
  fk_step_kernel<FMT><<<blocks, kWarps * 32, smem, stream>>>(
      cst, patch, state, tv, sxy, pts, B, P, n_k, out);
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: 0 = zu, 1 = muq, 2 = pairmu, 3 = packed, 4 = exact, 5 = pair3.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fk_step_launch(int fmt, const float* cst, const void* patch,
                              const float* state, const float* tv,
                              const float* sxy, const float* pts, int B, int P,
                              int n_k, float* out, cudaStream_t stream) {
  if (B == 0) return 0;
  const uint32_t* w = static_cast<const uint32_t*>(patch);
  switch (fmt) {
    case kZu:
      return launch<kZu>(cst, w, state, tv, sxy, pts, B, P, n_k, out, stream);
    case kMuq:
      return launch<kMuq>(cst, w, state, tv, sxy, pts, B, P, n_k, out, stream);
    case kPairMu:
      return launch<kPairMu>(cst, w, state, tv, sxy, pts, B, P, n_k, out,
                             stream);
    case kPacked:
      return launch<kPacked>(cst, w, state, tv, sxy, pts, B, P, n_k, out,
                             stream);
    case kExact:
      return launch<kExact>(cst, w, state, tv, sxy, pts, B, P, n_k, out,
                            stream);
    case kPair3:
      return launch<kPair3>(cst, w, state, tv, sxy, pts, B, P, n_k, out,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
