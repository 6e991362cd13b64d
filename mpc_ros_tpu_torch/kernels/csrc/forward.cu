// The fused multi-alpha line search (K5), one Hopper kernel (sm_90a).
//
// Replaces the Pallas TPU kernel mpc_ros_tpu/kernels/forward_pallas.py
// (`_kernel`, launched by `forward_pallas`), the forward half of the legacy
// two-kernel route (SolverConfig.backward="pallas"). The plain PyTorch
// version, with the same operation order, is forward_plain in
// kernels/forward.py.
//
// Bound on this card. Per scenario and launch the function reads ss
// (T+1, 8), us (T, 2), ks (T, 2), Ks (T, 2, 8), the P coefficients, 12
// parameters, lb/ub, cost and act, and writes ss (T+1, 8), us (T, 2), cost
// and accepted: 1,142 floats (4.57 KB) at T = 29, P = 4, so 2.40 GB at
// B = 524,288, >= 0.72 ms at 3.35 TB/s. The arithmetic is ~90 flops per
// candidate and stage plus the re-roll (~24k per scenario at n_alpha = 8,
// ~13 GFLOP at that batch, ~0.19 ms at 67 TFLOP/s f32), so the kernel is
// bound by memory.
//
// Design. One thread owns one scenario. The n_alpha candidate rollouts
// (alpha = 0.5^j) advance together over t, their running states S[a][8]
// and cost sums kept in registers (the TPU kernel parked them in a VMEM
// scratch); a template on n_alpha (1..8) unrolls them. Each stage reads
// ss[t], us[t], ks[t] and Ks[t] once for all candidates. The first
// (largest) alpha that lowers the cost wins through the `take` ladder, and
// the winner is re-rolled, writing ss/us through the mask upd = accepted *
// act with the multiply blend upd*new + (1-upd)*old. Every array is batch-
// minor ([...][lane]), so a warp's 32 accesses of one row are consecutive.
//
// Reference behaviours kept: the full 8-column K ds sum (K is an input
// here; the megakernel's structural zero in column 4 is not a contract of
// this kernel); the multiply blend; act gates the update, not the
// acceptance flag; exact sinf/cosf (the route has no fast trig). No
// --use_fast_math; nvcc contracts a*b+c into FMAs, so the kernel agrees
// with its plain version to f32 rounding, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "tiles.cuh"

namespace fwd {

using mega::clampf;
using mega::kPMax;
using mega::polyval;

// packed-parameter rows (kernels/pack.py)
enum {
  P_WCTE = 0, P_WETH, P_WVEL, P_WANG, P_WACC, P_WDANG, P_WDACC,
  P_RVEL, P_RCTE, P_RETH, P_DT, P_LF, N_PAR
};

struct Args {
  const float* ss;    // (T+1, 8, B)
  const float* us;    // (T, 2, B)
  const float* ks;    // (T, 2, B)
  const float* Ks;    // (T, 2, 8, B)
  const float* cf;    // (P, B)
  const float* par;   // (12, B)
  const float* lb;    // (2, B)
  const float* ub;    // (2, B)
  const float* cost;  // (B,)
  const float* act;   // (B,)
  float* ss_out;      // (T+1, 8, B)
  float* us_out;      // (T, 2, B)
  float* cost_out;    // (B,)
  float* acc_out;     // (B,)
  int P, B, T;
  float sign;
};

// Per-scenario constants of the cost and dynamics.
struct Problem {
  float c[kPMax];
  int P;
  float dt, sign;
  float wcte, weth, wvel, wang, wacc, wdang, wdacc;
  float rc, re, rv;
  float lb0, lb1, ub0, ub1;

  __device__ float stage_cost(const float (&s)[8], float u0, float u1,
                              float rate) const {
    const float du0 = u0 - s[6];
    const float du1 = u1 - s[7];
    const float e4 = s[4] - rc, e5 = s[5] - re, e3 = s[3] - rv;
    return wcte * (e4 * e4) + weth * (e5 * e5) + wvel * (e3 * e3) +
           wang * (u0 * u0) + wacc * (u1 * u1) +
           rate * (wdang * (du0 * du0) + wdacc * (du1 * du1));
  }

  __device__ float term_cost(const float (&s)[8]) const {
    const float e4 = s[4] - rc, e5 = s[5] - re, e3 = s[3] - rv;
    return wcte * (e4 * e4) + weth * (e5 * e5) + wvel * (e3 * e3);
  }

  // u = clip(u_b + alpha k + K ds), ds = s - s_b, the full 8-column sum
  __device__ void feedback(const float (&s)[8], const float (&s_b)[8],
                           float ub_0, float ub_1, float alpha, float k0,
                           float k1, const float (&K0)[8],
                           const float (&K1)[8], float& u0,
                           float& u1) const {
    float ds[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) ds[j] = s[j] - s_b[j];
    float sum0 = K0[0] * ds[0], sum1 = K1[0] * ds[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      sum0 = sum0 + K0[j] * ds[j];
      sum1 = sum1 + K1[j] * ds[j];
    }
    u0 = clampf(ub_0 + alpha * k0 + sum0, lb0, ub0);
    u1 = clampf(ub_1 + alpha * k1 + sum1, lb1, ub1);
  }

  // one ZOH-Euler step of the augmented state, in place (exact trig)
  __device__ void step(float (&s)[8], float u0, float u1) const {
    const float x = s[0], y = s[1], th = s[2], v = s[3], eth = s[5];
    const float f0 = polyval(c, P, x);
    s[0] = x + v * cosf(th) * dt;
    s[1] = y + v * sinf(th) * dt;
    s[2] = th + u0 * dt;
    s[3] = v + u1 * dt;
    s[4] = (f0 - y) + sign * v * sinf(eth) * dt;
    s[5] = eth + u0 * dt;
    s[6] = u0;
    s[7] = u1;
  }
};

// Knot t of the inputs: s_b = ss[t], u_b = us[t], k = ks[t], K = Ks[t].
struct Knot {
  float s_b[8], ub_0, ub_1, k0, k1, K0[8], K1[8];
  __device__ void load(const Args& a, size_t B, int lane, int t) {
#pragma unroll
    for (int r = 0; r < 8; ++r) s_b[r] = a.ss[(size_t)(t * 8 + r) * B + lane];
    ub_0 = a.us[(size_t)(t * 2) * B + lane];
    ub_1 = a.us[(size_t)(t * 2 + 1) * B + lane];
    k0 = a.ks[(size_t)(t * 2) * B + lane];
    k1 = a.ks[(size_t)(t * 2 + 1) * B + lane];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      K0[j] = a.Ks[(size_t)((t * 2) * 8 + j) * B + lane];
      K1[j] = a.Ks[(size_t)((t * 2 + 1) * 8 + j) * B + lane];
    }
  }
};

template <int NA>
__global__ void __launch_bounds__(128) forward_kernel(const Args a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  const size_t B = a.B;
  const int T = a.T;

  float par[N_PAR];
#pragma unroll
  for (int r = 0; r < N_PAR; ++r) par[r] = a.par[r * B + lane];
  Problem pr;
  pr.P = a.P;
#pragma unroll
  for (int i = 0; i < kPMax; ++i)
    pr.c[i] = i < a.P ? a.cf[i * B + lane] : 0.0f;
  pr.dt = par[P_DT];
  pr.sign = a.sign;
  pr.wcte = par[P_WCTE];
  pr.weth = par[P_WETH];
  pr.wvel = par[P_WVEL];
  pr.wang = par[P_WANG];
  pr.wacc = par[P_WACC];
  pr.wdang = par[P_WDANG];
  pr.wdacc = par[P_WDACC];
  pr.rc = par[P_RCTE];
  pr.re = par[P_RETH];
  pr.rv = par[P_RVEL];
  pr.lb0 = a.lb[lane];
  pr.lb1 = a.lb[B + lane];
  pr.ub0 = a.ub[lane];
  pr.ub1 = a.ub[B + lane];
  const float cost_prev = a.cost[lane];
  const float act = a.act[lane];

  float s0[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) s0[r] = a.ss[(size_t)r * B + lane];

  // ---- the NA candidate rollouts, advancing together over t ----
  float S[NA][8], accs[NA];
#pragma unroll
  for (int al = 0; al < NA; ++al) {
#pragma unroll
    for (int r = 0; r < 8; ++r) S[al][r] = s0[r];
    accs[al] = 0.0f;
  }
  for (int t = 0; t < T; ++t) {
    Knot kn;
    kn.load(a, B, lane, t);
    const float rate = t >= 1 ? 1.0f : 0.0f;
#pragma unroll
    for (int al = 0; al < NA; ++al) {
      const float alpha = 1.0f / (float)(1 << al);
      float u0, u1;
      pr.feedback(S[al], kn.s_b, kn.ub_0, kn.ub_1, alpha, kn.k0, kn.k1,
                  kn.K0, kn.K1, u0, u1);
      accs[al] = accs[al] + pr.stage_cost(S[al], u0, u1, rate);
      pr.step(S[al], u0, u1);
    }
  }

  // ---- acceptance: the first (largest) alpha that lowers the cost ----
  float picked = 0.0f, alpha_sel = 0.0f, cost_sel = cost_prev;
#pragma unroll
  for (int al = 0; al < NA; ++al) {
    const float cost_a = accs[al] + pr.term_cost(S[al]);
    const float improved = cost_a < cost_prev ? 1.0f : 0.0f;
    const float take = improved * (1.0f - fminf(picked, 1.0f));
    picked = picked + take;
    alpha_sel = alpha_sel + take * (1.0f / (float)(1 << al));
    cost_sel = take > 0.5f ? cost_a : cost_sel;
  }
  const float accepted = fminf(picked, 1.0f);
  const float upd = accepted * act;  // only active lanes move
  const float keep = 1.0f - upd;

  // ---- re-roll the winner, writing through the mask ----
#pragma unroll
  for (int r = 0; r < 8; ++r) a.ss_out[(size_t)r * B + lane] = s0[r];
  float sa[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) sa[r] = s0[r];
  for (int t = 0; t < T; ++t) {
    Knot kn;
    kn.load(a, B, lane, t);
    float u0, u1;
    pr.feedback(sa, kn.s_b, kn.ub_0, kn.ub_1, alpha_sel, kn.k0, kn.k1, kn.K0,
                kn.K1, u0, u1);
    pr.step(sa, u0, u1);
    a.us_out[(size_t)(t * 2) * B + lane] = upd * u0 + keep * kn.ub_0;
    a.us_out[(size_t)(t * 2 + 1) * B + lane] = upd * u1 + keep * kn.ub_1;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const size_t o = (size_t)((t + 1) * 8 + r) * B + lane;
      a.ss_out[o] = upd * sa[r] + keep * a.ss[o];
    }
  }
  a.cost_out[lane] = upd > 0.5f ? cost_sel : cost_prev;
  a.acc_out[lane] = accepted;
}

}  // namespace fwd

// Each build instantiates one n_alpha, chosen by this macro
// (kernels/_build.py passes it; the default is the Gauss-Newton profile's 8).
#ifndef FWD_NALPHA
#define FWD_NALPHA 8
#endif

// Error code for a request of an n_alpha this library was not built for.
#define FWD_ERR_VARIANT 100000

extern "C" int mpc_forward_f32(const void* ss, const void* us,
                               const void* ks, const void* Ks,
                               const void* cf, const void* par,
                               const void* lb, const void* ub,
                               const void* cost, const void* act,
                               void* ss_out, void* us_out, void* cost_out,
                               void* acc_out, int P, int B, int T,
                               float sign, int n_alpha, void* stream) {
  if (n_alpha != FWD_NALPHA) return FWD_ERR_VARIANT;
  fwd::Args a;
  a.ss = static_cast<const float*>(ss);
  a.us = static_cast<const float*>(us);
  a.ks = static_cast<const float*>(ks);
  a.Ks = static_cast<const float*>(Ks);
  a.cf = static_cast<const float*>(cf);
  a.par = static_cast<const float*>(par);
  a.lb = static_cast<const float*>(lb);
  a.ub = static_cast<const float*>(ub);
  a.cost = static_cast<const float*>(cost);
  a.act = static_cast<const float*>(act);
  a.ss_out = static_cast<float*>(ss_out);
  a.us_out = static_cast<float*>(us_out);
  a.cost_out = static_cast<float*>(cost_out);
  a.acc_out = static_cast<float*>(acc_out);
  a.P = P;
  a.B = B;
  a.T = T;
  a.sign = sign;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  fwd::forward_kernel<FWD_NALPHA>
      <<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mpc_cuda_error_string(int err) {
  if (err == FWD_ERR_VARIANT)
    return "library built for another n_alpha";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
