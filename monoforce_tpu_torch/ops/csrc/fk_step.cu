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
// sum of squared deviations).  The formats differ only in how the taps are
// decoded and in the spring std; everything else is one body.
// The TPU's two-trajectories-per-register packing, its lane gathers, its
// ones-matmul reductions and its ghost points are layout, not semantics.
// Dropping the ghosts changes one term: on the TPU each ghost lane adds
// sqrt(1e-30) = 1e-15 N to the spring sum (and 1e-30 to the sum of
// squares), which is below float32 resolution of any real statistic.
//
// Per trajectory: state (18) = [x(3) v(3) R(9, row-major) omega(3)], track
// velocities tv (n_k), window corner sxy (2), window words (256 or 512
// 32-bit words).  Points pts (7, P) = [px, py, pz, drive_mask_0..3].
// Output (8) = [ax, ay, az, aw0, aw1, aw2, spring_std, n_contacts].
//
// The serving rollout's step (fk_step_into_launch) takes the same launch
// one step further: given an output state row, warp 0's lane 0 integrates
// its trajectory as physics/fast.py::_integrate does (semi-implicit Euler,
// then the Rodrigues update of R), op by op with round-to-nearest
// intrinsics and no FMA contraction, and writes the next state and the
// spring std in place of the eight outputs.  States are read and written
// through row strides, so step k of a rollout reads row k-1 of its
// (B, N, 18) sequence and writes row k: one launch a step, and nothing
// between the launches.  The branch is taken at run time, in the same
// instantiation, so each format stays one kernel.
//
// What bounds it on the H100.  At the shooting batch (B=4096), operations:
// ~150-165 float operations a point against well under a kilobyte of
// touched window words and state a trajectory.  In practice dispatching
// the instructions a warp runs (beside the float operations: indexing,
// conversions, broadcast loads, shuffles, and the IEEE square root,
// reciprocals and exp) and their latency set the time, several times the
// float-operation bound (PERF.md, section 6).  At the planner tick's batch
// (B=64, 500 launches a tick), the latency of one launch: 64 trajectories
// are a few thousand points, a fraction of one wave, so the time is the
// launch plus one block's chain of two dependent loads, the arithmetic of
// one point and the reductions.
//
// Design.  One block per trajectory, one thread per contact point
// (32 * ceil(P / 32) threads; the ragged last warp recomputes point P-1 and
// contributes zeros), so every point of a trajectory runs at once and the
// tick's 64 blocks run 64 chains of one point each.  Each thread evaluates
// its point once and keeps what the force pass needs (r, v, n, dh, mu,
// contact) in registers across the contact-count reduction.  Nothing is
// staged: each thread loads its own point's seven plane values (coalesced:
// the planes are (7, P)) and the trajectory's state, tv and corner
// (broadcast), computes its cell, and reads its 2-8 taps straight from the
// window in device memory through the read-only path, while the velocity,
// the weights and the drive command run under the loads; a whole-window
// copy would move every word, more than twice the words the taps touch.
// The reductions are one fixed tree for a given P in every format: warp
// shuffles (the eight sums by a reduce-scatter butterfly, 9 shuffles where
// eight separate sums take 40), one partial per warp in shared memory, and
// the warps' partials added in warp order (the eight sums in warp 0, lanes
// in parallel); so muq and pair3 give bit-equal contact counts on the same
// z.  The two-pass formats keep each
// point's spring force in a register and take the squared deviations in a
// third reduction.  1/res and 1/n_cp are taken once a thread and 1/m once a
// trajectory and multiplied by, in place of three divides a point.  The
// index path (world point -> cell) keeps round-to-nearest intrinsics in the
// plain version's order, so that no FMA contraction moves a point across a
// cell boundary away from the plain PyTorch version, and the bilinear z is
// one pinned FMA chain, so every format rounds it alike.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;            // P <= 256
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Eight warp sums at once: each butterfly step sends the half of the
// values that the partner keeps.  On return lane l holds the warp's sum of
// a[(l >> 2) & 7].
__device__ __forceinline__ float warp_sum8(const float (&a)[8], int lane) {
  const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4;
  float h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = (u16 ? a[i + 4] : a[i]) +
           __shfl_xor_sync(kFull, u16 ? a[i] : a[i + 4], 16);
  float q[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    q[i] = (u8 ? h[i + 2] : h[i]) +
           __shfl_xor_sync(kFull, u8 ? h[i] : h[i + 2], 8);
  float v = (u4 ? q[1] : q[0]) + __shfl_xor_sync(kFull, u4 ? q[0] : q[1], 4);
  v += __shfl_xor_sync(kFull, v, 2);
  v += __shfl_xor_sync(kFull, v, 1);
  return v;
}

// The sum of the per-warp partials part[0..n_warps) in warp order, the
// same in every thread that asks; part is 16-byte aligned, kMaxWarps long.
__device__ __forceinline__ float block_total(const float* part, int n_warps) {
  const float4 a = reinterpret_cast<const float4*>(part)[0];
  const float4 c = reinterpret_cast<const float4*>(part)[1];
  const float v[kMaxWarps] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  float s = v[0];
#pragma unroll
  for (int i = 1; i < kMaxWarps; ++i) s += i < n_warps ? v[i] : 0.0f;
  return s;
}

// a u8 field of a word as float, exactly: the byte in the mantissa of 2^23
__device__ __forceinline__ float u8_float(uint32_t w, int shift) {
  return __uint_as_float(0x4B000000u | ((w >> shift) & 255u)) - 8388608.0f;
}

// dot of a rotation row with a body point, rounded op by op
__device__ __forceinline__ float rot_rn(float a, float b, float c, float px,
                                        float py, float pz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)),
                   __fmul_rn(c, pz));
}

// Semi-implicit Euler and R <- R (I + sin(th dt) K + (1 - cos(th dt))
// (k k^T - I)) for one trajectory, from its state s (18) and accelerations
// a (6), into next (18): the operations of _integrate in its order, each
// rounded to nearest on its own as each torch operation is.
__device__ __forceinline__ void integrate_rn(const float* __restrict__ s,
                                              const float (&a)[6], float dt,
                                              float* __restrict__ next) {
  float v[3], x[3], w[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v[i] = __fadd_rn(__ldg(s + 3 + i), __fmul_rn(a[i], dt));
    x[i] = __fadd_rn(__ldg(s + i), __fmul_rn(v[i], dt));
    w[i] = __fadd_rn(__ldg(s + 15 + i), __fmul_rn(a[3 + i], dt));
  }
  const float theta = sqrtf(__fadd_rn(
      __fadd_rn(__fmul_rn(w[0], w[0]), __fmul_rn(w[1], w[1])),
      __fmul_rn(w[2], w[2])));
  const float th = fmaxf(theta, 1e-6f);
  const float k[3] = {__fdiv_rn(w[0], th), __fdiv_rn(w[1], th),
                      __fdiv_rn(w[2], th)};
  const float ang = __fmul_rn(theta, dt);
  const float sn = sinf(ang);
  const float c1 = __fsub_rn(1.0f, cosf(ang));
  // K = [k]_x, row-major
  const float K[9] = {0.0f, -k[2], k[1], k[2], 0.0f, -k[0],
                      -k[1], k[0], 0.0f};
  float M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      M[3 * i + j] = __fadd_rn(
          __fadd_rn(eye, __fmul_rn(sn, K[3 * i + j])),
          __fmul_rn(c1, __fsub_rn(__fmul_rn(k[i], k[j]), eye)));
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    next[i] = x[i];
    next[3 + i] = v[i];
    next[15 + i] = w[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float r0 = __ldg(s + 6 + 3 * i), r1 = __ldg(s + 7 + 3 * i);
    const float r2 = __ldg(s + 8 + 3 * i);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      next[6 + 3 * i + j] = __fadd_rn(
          __fadd_rn(__fmul_rn(r0, M[j]), __fmul_rn(r1, M[3 + j])),
          __fmul_rn(r2, M[6 + j]));
  }
}

// state: rows of 18 floats, row b at b * state_stride.  With next_state
// null, writes the eight outputs to out (B, 8); otherwise the next state to
// row b of next_state (b * next_stride) and the spring std to
// spring_out[b * spring_stride], and out is not touched.
template <int FMT>
__global__ void __launch_bounds__(kMaxThreads)
fk_step_kernel(const float* __restrict__ cst,
               const uint32_t* __restrict__ patch,
               const float* __restrict__ state, int state_stride,
               const float* __restrict__ tv, const float* __restrict__ sxy,
               const float* __restrict__ pts, int P, int n_k,
               float* __restrict__ out, float* __restrict__ next_state,
               int next_stride, float* __restrict__ spring_out,
               int spring_stride) {
  constexpr int W = Traits<FMT>::kWords;
  constexpr bool kDivide = Traits<FMT>::kDivide;
  __shared__ __align__(16) float s_ncp[kMaxWarps];
  __shared__ __align__(16) float s_acc[8][kMaxWarps];
  __shared__ __align__(16) float s_dev[kMaxWarps];

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool real = (int)threadIdx.x < P;
  const int p = real ? (int)threadIdx.x : P - 1;

  // this point's planes, then the trajectory's row (broadcast loads)
  const float px = __ldg(pts + p);
  const float py = __ldg(pts + P + p);
  const float pz = __ldg(pts + 2 * P + p);
  float mask[4], tvk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    mask[k] = k < n_k ? __ldg(pts + (3 + k) * P + p) : 0.0f;
    tvk[k] = k < n_k ? __ldg(tv + (size_t)b * n_k + k) : 0.0f;
  }
  const float* s = state + (size_t)b * state_stride;
  const float x0 = __ldg(s + 0), x1 = __ldg(s + 1), x2 = __ldg(s + 2);
  const float v0 = __ldg(s + 3), v1 = __ldg(s + 4), v2 = __ldg(s + 5);
  const float r00 = __ldg(s + 6), r01 = __ldg(s + 7), r02 = __ldg(s + 8);
  const float r10 = __ldg(s + 9), r11 = __ldg(s + 10), r12 = __ldg(s + 11);
  const float r20 = __ldg(s + 12), r21 = __ldg(s + 13), r22 = __ldg(s + 14);
  const float w0 = __ldg(s + 15), w1 = __ldg(s + 16), w2 = __ldg(s + 17);
  // the window's corner cell, truncated as the plain version's int32 cast
  const float sx = truncf(__ldg(sxy + 2 * b));
  const float sy = truncf(__ldg(sxy + 2 * b + 1));
  const float d_max = __ldg(cst + C_DMAX), res = __ldg(cst + C_RES);
  const float inv_res = __frcp_rn(res);  // == 1.0f / res, as the plain version

  // the index path, op by op in the plain version's order
  const float rx = rot_rn(r00, r01, r02, px, py, pz);
  const float ry = rot_rn(r10, r11, r12, px, py, pz);
  const float rz = rot_rn(r20, r21, r22, px, py, pz);
  const float wx = __fadd_rn(rx, x0);
  const float wy = __fadd_rn(ry, x1);
  const float wz = __fadd_rn(rz, x2);
  const float fxq = kDivide ? __fdiv_rn(__fadd_rn(wx, d_max), res)
                            : __fmul_rn(__fadd_rn(wx, d_max), inv_res);
  const float fyq = kDivide ? __fdiv_rn(__fadd_rn(wy, d_max), res)
                            : __fmul_rn(__fadd_rn(wy, d_max), inv_res);
  // truncation toward zero; on integer-valued floats the cell arithmetic
  // is exact, as the plain version's int32 arithmetic, until the clamps
  const float xt = truncf(fxq), yt = truncf(fyq);
  const int idx = (int)(clampf(xt - sx, 0.0f, 14.0f) * 16.0f +
                        clampf(yt - sy, 0.0f, 14.0f));

  // the taps, straight from the window in device memory
  const uint32_t* win = patch + (size_t)b * W + idx;
  uint32_t c0 = 0, c1 = 0, c2 = 0, c3 = 0, mq = 0;
  float e[8] = {};
  if (FMT == kExact) {
    // f32 planes: z in words 0-255, mu in 256-511
    const float* wf = reinterpret_cast<const float*>(win);
    e[0] = __ldg(wf);
    e[1] = __ldg(wf + 16);
    e[2] = __ldg(wf + 1);
    e[3] = __ldg(wf + 17);
    e[4] = __ldg(wf + 256);
    e[5] = __ldg(wf + 272);
    e[6] = __ldg(wf + 257);
    e[7] = __ldg(wf + 273);
  } else {
    c0 = __ldg(win);
    c1 = __ldg(win + 16);
    if (Traits<FMT>::kZMuWords) {
      c2 = __ldg(win + 1);
      c3 = __ldg(win + 17);
    }
    if (FMT == kMuq) mq = __ldg(win + 256);
  }

  // under the loads: the point velocity, the weights, the track direction
  // and the drive command
  const float vx = v0 + w1 * rz - w2 * ry;
  const float vy = v1 + w2 * rx - w0 * rz;
  const float vz = v2 + w0 * ry - w1 * rx;
  const float xf = fxq - xt;
  const float yf = fyq - yt;
  const float w_cc = (1.0f - xf) * (1.0f - yf);
  const float w_cf = (1.0f - xf) * yf;
  const float w_lc = xf * (1.0f - yf);
  const float w_fl = xf * yf;
  const float tn = rsqrtf(fmaxf(r00 * r00 + r10 * r10 + r20 * r20, 1e-12f));
  const float tx = r00 * tn, ty = r10 * tn, tz = r20 * tn;
  float cmd = tvk[0] * mask[0];
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (k < n_k) cmd += tvk[k] * mask[k];

  float t0, t1, t2, t3, mu = 1.0f;
  if (FMT == kExact) {
    t0 = e[0];
    t1 = e[1];
    t2 = e[2];
    t3 = e[3];
    mu = w_cc * e[4] + w_cf * e[5] + w_lc * e[6] + w_fl * e[7];
  } else if (Traits<FMT>::kZMuWords) {
    // z from the four taps' high halves; mu from the tap-0 cell's low half
    // (kPairMu) or bilinear over the low halves
    t0 = hi_half(c0);
    t1 = hi_half(c1);
    t2 = hi_half(c2);
    t3 = hi_half(c3);
    mu = FMT == kPairMu ? lo_half(c0)
                        : w_cc * lo_half(c0) + w_cf * lo_half(c1) +
                              w_lc * lo_half(c2) + w_fl * lo_half(c3);
  } else {
    // z-pair words [z(i,j) | z(i,j+1)]: two reads give all four taps
    t0 = hi_half(c0);
    t1 = hi_half(c1);
    t2 = lo_half(c0);
    t3 = lo_half(c1);
    if (FMT == kMuq) {
      // u8 quad of this cell's four friction taps, scale 1/64
      const float m0 = u8_float(mq, 24), m1 = u8_float(mq, 16);
      const float m2 = u8_float(mq, 8), m3 = u8_float(mq, 0);
      mu = (w_cc * m0 + w_cf * m1 + w_lc * m2 + w_fl * m3) * (1.0f / 64.0f);
    }
  }
  const float z = __fmaf_rn(w_fl, t3, __fmaf_rn(w_lc, t2,
                  __fmaf_rn(w_cf, t1, __fmul_rn(w_cc, t0))));
  const float dz_dx = (t1 - t0) * inv_res;
  const float dz_dy = (t2 - t0) * inv_res;
  const float ninv = rsqrtf(dz_dx * dz_dx + dz_dy * dz_dy + 1.0f);
  const float nx = -dz_dx * ninv;
  const float ny = -dz_dy * ninv;
  const float nz = ninv;
  const float dh = __fsub_rn(wz, z);
  // exp overflows to inf far above the terrain: contact is then 0
  const float contact = __frcp_rn(1.0f + expf(10.0f * dh));

  // the contact count that normalises the spring forces
  const float c_part = warp_sum(real ? contact : 0.0f);
  if (lane == 0) s_ncp[warp] = c_part;
  __syncthreads();
  const float n_cp = block_total(s_ncp, n_warps);
  // exactly-zero guard only
  const float inv_n = __frcp_rn(n_cp > 0.0f ? n_cp : 1.0f);

  // forces, torques and the spring statistics
  const float stiff = __ldg(cst + C_STIFF), damp = __ldg(cst + C_DAMP);
  const float m = __ldg(cst + C_MASS), g = __ldg(cst + C_G);
  const float mg = m * g;
  const float vn = vx * nx + vy * ny + vz * nz;
  const float cs = -(stiff * dh + damp * vn) * contact * inv_n;
  const float fsx = clampf(cs * nx, -mg, mg);
  const float fsy = clampf(cs * ny, -mg, mg);
  const float fsz = clampf(cs * nz, -mg, mg);
  const float spring = sqrtf(fsx * fsx + fsy * fsy + fsz * fsz + 1e-30f);
  float sfx = cmd * tx - vx;
  float sfy = cmd * ty - vy;
  float sfz = cmd * tz - vz;
  if (FMT != kZu) {
    sfx *= mu;
    sfy *= mu;
    sfz *= mu;
  }
  const float sn = sfx * nx + sfy * ny + sfz * nz;
  const float fx = fsx + clampf(spring * (sfx - sn * nx), -mg, mg);
  const float fy = fsy + clampf(spring * (sfy - sn * ny), -mg, mg);
  const float fz = fsz + clampf(spring * (sfz - sn * nz), -mg, mg);
  float acc[8] = {ry * fz - rz * fy, rz * fx - rx * fz, rx * fy - ry * fx,
                  fx, fy, fz, spring, spring * spring};
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = real ? acc[i] : 0.0f;
  const float a_part = warp_sum8(acc, lane);
  if ((lane & 3) == 0) s_acc[lane >> 2][warp] = a_part;
  __syncthreads();

  const float inv_nreal = __frcp_rn(__ldg(cst + C_NREAL));
  float dev_sum = 0.0f;
  if (kDivide) {
    // second pass over the spring forces held in registers
    const float d = spring - block_total(s_acc[6], n_warps) * inv_nreal;
    const float dev_part = warp_sum(real ? d * d : 0.0f);
    if (lane == 0) s_dev[warp] = dev_part;
    __syncthreads();
    if (warp == 0) dev_sum = block_total(s_dev, n_warps);
  }
  if (warp != 0) return;

  // warp 0: the eight block totals; lane l adds sum l >> 2 of warps l & 3
  // and (l & 3) + 4, then two butterfly steps
  const int qi = lane >> 2, wi = lane & 3;
  float tot = (wi < n_warps ? s_acc[qi][wi] : 0.0f) +
              (wi + 4 < n_warps ? s_acc[qi][wi + 4] : 0.0f);
  tot += __shfl_xor_sync(kFull, tot, 1);
  tot += __shfl_xor_sync(kFull, tot, 2);
  float sum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) sum[i] = __shfl_sync(kFull, tot, 4 * i);
  if (lane != 0) return;
  // uncontracted, so that equal spring forces (P = 1) give exactly 0
  const float s_mean = sum[6] * inv_nreal;
  const float s_var =
      kDivide ? dev_sum * inv_nreal
              : fmaxf(__fsub_rn(__fmul_rn(sum[7], inv_nreal),
                                __fmul_rn(s_mean, s_mean)),
                      0.0f);
  const float om = __ldg(cst + C_OMAX);
  const float i00 = __ldg(cst + C_I00), i01 = __ldg(cst + C_I01);
  const float i02 = __ldg(cst + C_I02), i11 = __ldg(cst + C_I11);
  const float i12 = __ldg(cst + C_I12), i22 = __ldg(cst + C_I22);
  const float inv_m = __frcp_rn(m);
  float o[8];
  o[0] = (mg * __ldg(cst + C_GD0) + sum[3]) * inv_m;
  o[1] = (mg * __ldg(cst + C_GD1) + sum[4]) * inv_m;
  o[2] = (mg * __ldg(cst + C_GD2) + sum[5]) * inv_m;
  o[3] = clampf(i00 * sum[0] + i01 * sum[1] + i02 * sum[2], -om, om);
  o[4] = clampf(i01 * sum[0] + i11 * sum[1] + i12 * sum[2], -om, om);
  o[5] = clampf(i02 * sum[0] + i12 * sum[1] + i22 * sum[2], -om, om);
  o[6] = sqrtf(s_var + 1e-30f);
  o[7] = n_cp;
  if (next_state == nullptr) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[(size_t)b * 8 + i] = o[i];
    return;
  }
  // the state is read again (from L1) rather than held in registers
  // through the whole step
  const float acc6[6] = {o[0], o[1], o[2], o[3], o[4], o[5]};
  integrate_rn(s, acc6, __ldg(cst + C_DT),
               next_state + (size_t)b * next_stride);
  spring_out[(size_t)b * spring_stride] = o[6];
}

struct Args {
  const float* cst;
  const uint32_t* patch;
  const float* state;
  int state_stride;
  const float* tv;
  const float* sxy;
  const float* pts;
  int B, P, n_k;
  float* out;
  float* next;
  int next_stride;
  float* spring;
  int spring_stride;
};

template <int FMT>
int launch(const Args& a, cudaStream_t stream) {
  const unsigned threads = (unsigned)((a.P + 31) / 32 * 32);
  fk_step_kernel<FMT><<<(unsigned)a.B, threads, 0, stream>>>(
      a.cst, a.patch, a.state, a.state_stride, a.tv, a.sxy, a.pts, a.P, a.n_k,
      a.out, a.next, a.next_stride, a.spring, a.spring_stride);
  return (int)cudaGetLastError();
}

int dispatch(int fmt, const Args& a, cudaStream_t stream) {
  if (a.B == 0) return 0;
  if (a.B < 0 || a.P < 1 || a.P > kMaxThreads || a.n_k < 1 || a.n_k > 4)
    return (int)cudaErrorInvalidValue;
  switch (fmt) {
    case kZu:
      return launch<kZu>(a, stream);
    case kMuq:
      return launch<kMuq>(a, stream);
    case kPairMu:
      return launch<kPairMu>(a, stream);
    case kPacked:
      return launch<kPacked>(a, stream);
    case kExact:
      return launch<kExact>(a, stream);
    case kPair3:
      return launch<kPair3>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// fmt: 0 = zu, 1 = muq, 2 = pairmu, 3 = packed, 4 = exact, 5 = pair3.
// state (B, 18) contiguous; writes out (B, 8).  Launches on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int fk_step_launch(int fmt, const float* cst, const void* patch,
                              const float* state, const float* tv,
                              const float* sxy, const float* pts, int B, int P,
                              int n_k, float* out, cudaStream_t stream) {
  const Args a{cst, static_cast<const uint32_t*>(patch), state, 18, tv, sxy,
               pts, B, P, n_k, out, nullptr, 0, nullptr, 0};
  return dispatch(fmt, a, stream);
}

// One serving rollout step: the state of trajectory b from
// state[b * state_stride], the next state into next[b * next_stride] and
// the spring std into spring[b * spring_stride] (strides in floats).
extern "C" int fk_step_into_launch(int fmt, const float* cst,
                                   const void* patch, const float* state,
                                   int state_stride, const float* tv,
                                   const float* sxy, const float* pts, int B,
                                   int P, int n_k, float* next,
                                   int next_stride, float* spring,
                                   int spring_stride, cudaStream_t stream) {
  if (next == nullptr || spring == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{cst, static_cast<const uint32_t*>(patch), state, state_stride,
               tv, sxy, pts, B, P, n_k, nullptr, next, next_stride, spring,
               spring_stride};
  return dispatch(fmt, a, stream);
}
