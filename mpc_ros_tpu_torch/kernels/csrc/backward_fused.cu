// The Riccati backward scan with inline linearization (K4), one Hopper
// kernel (sm_90a).
//
// Replaces the Pallas TPU kernel mpc_ros_tpu/kernels/backward_fused_pallas.py
// (`_kernel`, launched by `backward_fused_pallas`), the backward half of the
// legacy two-kernel route (SolverConfig.backward="pallas"): Gauss-Newton
// only, diff-drive only. The plain PyTorch version, with the same operation
// order, is backward_fused_plain in kernels/backward_fused.py.
//
// Bound on this card. Per scenario and launch the function reads ss
// (T+1, 8), us (T, 2), the P coefficients, 12 parameters, V_s (8), V_ss
// (8, 8), lb/ub and mu, and writes ks (T, 2), Ks (T, 2, 8), dV1, dV2 and pg:
// 916 floats (3.66 KB) at T = 29, P = 4, so 1.92 GB at B = 524,288, >= 0.57
// ms at 3.35 TB/s. The arithmetic is ~1.2k flops per stage (~35k per
// scenario, 18 GFLOP at that batch, ~0.27 ms at 67 TFLOP/s f32), so the
// kernel is bound by memory.
//
// Design. One thread owns one scenario and runs the reverse scan over t in
// a loop, carrying V_s (8) and the value Hessian V_ss (8 x 8, symmetric
// after the first stage) in registers. Each stage reads ss[t] and us[t] and
// writes ks[t] and Ks[t]; every array is batch-minor ([...][lane]), so a
// warp's 32 accesses of one row are consecutive addresses and each byte is
// touched once. The A/B products are expanded against the dynamics'
// sparsity (A has 15/64 nonzeros, B 5/16), and the exact 2-D box QP and the
// polynomial derivative are the device helpers of tiles.cuh (K2).
//
// Reference behaviours kept: Quu is symmetrized through the off-diagonal
// mean only; rows 4, 6 and 7 of the A^T contraction are zero; V_ss_n is
// built as the upper triangle and mirrored; pg is the plain (not weight-
// scale normalized) projected gradient; dV2 accumulates 0.5 k'(Quu k); the
// rate terms are on for t >= 1. Exact sinf/cosf and IEEE divisions (no
// --use_fast_math); nvcc contracts a*b+c into FMAs, so the kernel agrees
// with its plain version to f32 rounding, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "tiles.cuh"

namespace bwd {

using mega::boxqp;
using mega::clampf;
using mega::maxf;
using mega::kPMax;
using mega::polyder;

// packed-parameter rows (kernels/pack.py)
enum {
  P_WCTE = 0, P_WETH, P_WVEL, P_WANG, P_WACC, P_WDANG, P_WDACC,
  P_RVEL, P_RCTE, P_RETH, P_DT, P_LF, N_PAR
};

struct Args {
  const float* ss;    // (T+1, 8, B)
  const float* us;    // (T, 2, B)
  const float* cf;    // (P, B)
  const float* par;   // (12, B)
  const float* Vs0;   // (8, B)
  const float* Vss0;  // (8, 8, B)
  const float* lb;    // (2, B)
  const float* ub;    // (2, B)
  const float* mu;    // (B,)
  float* ks;          // (T, 2, B) out
  float* Ks;          // (T, 2, 8, B) out
  float* dv1;         // (B,) out
  float* dv2;
  float* pg;
  int P, B, T;
  float sign;
};

__global__ void __launch_bounds__(128) backward_fused_kernel(const Args a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  const size_t B = a.B;
  const int T = a.T;
  const float sign = a.sign;

  float par[N_PAR];
#pragma unroll
  for (int r = 0; r < N_PAR; ++r) par[r] = a.par[r * B + lane];
  float c[kPMax];
#pragma unroll
  for (int i = 0; i < kPMax; ++i) c[i] = i < a.P ? a.cf[i * B + lane] : 0.0f;
  const float dt = par[P_DT];
  const float wv2 = 2.0f * par[P_WVEL];
  const float wc2 = 2.0f * par[P_WCTE];
  const float we2 = 2.0f * par[P_WETH];
  const float ww2 = 2.0f * par[P_WANG];
  const float wa2 = 2.0f * par[P_WACC];
  const float lb0 = a.lb[lane], lb1 = a.lb[B + lane];
  const float ub0 = a.ub[lane], ub1 = a.ub[B + lane];
  const float mu = a.mu[lane];

  float Vs[8], V[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    Vs[i] = a.Vs0[i * B + lane];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      V[i][j] = a.Vss0[(size_t)(i * 8 + j) * B + lane];
  }

  float dv1 = 0.0f, dv2 = 0.0f, pg = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    float s[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) s[r] = a.ss[(size_t)(t * 8 + r) * B + lane];
    const float ut0 = a.us[(size_t)(t * 2) * B + lane];
    const float ut1 = a.us[(size_t)(t * 2 + 1) * B + lane];
    const float rate = t >= 1 ? 1.0f : 0.0f;
    const float x = s[0], th = s[2], v = s[3], cte = s[4], eth = s[5];
    const float ct = cosf(th), st = sinf(th);
    const float ce = cosf(eth), se = sinf(eth);
    const float fp = polyder(c, a.P, x);
    const float a02 = -v * st * dt;
    const float a03 = ct * dt;
    const float a12 = v * ct * dt;
    const float a13 = st * dt;
    const float a40 = fp;
    const float a43 = sign * se * dt;
    const float a45 = sign * v * ce * dt;

    const float wdw2 = 2.0f * rate * par[P_WDANG];
    const float wda2 = 2.0f * rate * par[P_WDACC];
    const float du0 = ut0 - s[6];
    const float du1 = ut1 - s[7];
    const float ls3 = wv2 * (v - par[P_RVEL]);
    const float ls4 = wc2 * (cte - par[P_RCTE]);
    const float ls5 = we2 * (eth - par[P_RETH]);
    const float lu0 = ww2 * ut0 + wdw2 * du0;
    const float lu1 = wa2 * ut1 + wda2 * du1;
    const float luu00 = ww2 + wdw2;
    const float luu11 = wa2 + wda2;

    // Qs = l_s + A' Vs (rows 4, 6, 7 of A' Vs are zero)
    float Qs[8];
    Qs[0] = 0.0f + (Vs[0] + a40 * Vs[4]);
    Qs[1] = 0.0f + (Vs[1] - Vs[4]);
    Qs[2] = 0.0f + (a02 * Vs[0] + a12 * Vs[1] + Vs[2]);
    Qs[3] = ls3 + (a03 * Vs[0] + a13 * Vs[1] + Vs[3] + a43 * Vs[4]);
    Qs[4] = ls4 + 0.0f;
    Qs[5] = ls5 + (a45 * Vs[4] + Vs[5]);
    Qs[6] = -wdw2 * du0 + 0.0f;
    Qs[7] = -wda2 * du1 + 0.0f;
    const float Qu0 = lu0 + (dt * (Vs[2] + Vs[5]) + Vs[6]);
    const float Qu1 = lu1 + (dt * Vs[3] + Vs[7]);

    // VA = V @ A by A's column structure: va[j][m], columns 4, 6, 7 zero
    float va[8][8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      va[0][m] = V[m][0] + a40 * V[m][4];
      va[1][m] = V[m][1] - V[m][4];
      va[2][m] = a02 * V[m][0] + a12 * V[m][1] + V[m][2];
      va[3][m] = a03 * V[m][0] + a13 * V[m][1] + V[m][3] + a43 * V[m][4];
      va[4][m] = 0.0f;
      va[5][m] = a45 * V[m][4] + V[m][5];
      va[6][m] = 0.0f;
      va[7][m] = 0.0f;
    }
    // Qss = A' VA + diag(l_ss); Qus = B' VA + l_us
    float Qss[8][8], qus0[8], qus1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* y = va[j];
      Qss[0][j] = y[0] + a40 * y[4];
      Qss[1][j] = y[1] - y[4];
      Qss[2][j] = a02 * y[0] + a12 * y[1] + y[2];
      Qss[3][j] = a03 * y[0] + a13 * y[1] + y[3] + a43 * y[4];
      Qss[4][j] = 0.0f;
      Qss[5][j] = a45 * y[4] + y[5];
      Qss[6][j] = 0.0f;
      Qss[7][j] = 0.0f;
      qus0[j] = dt * (y[2] + y[5]) + y[6];
      qus1[j] = dt * y[3] + y[7];
    }
    Qss[3][3] = Qss[3][3] + wv2;
    Qss[4][4] = Qss[4][4] + wc2;
    Qss[5][5] = Qss[5][5] + we2;
    Qss[6][6] = Qss[6][6] + wdw2;
    Qss[7][7] = Qss[7][7] + wda2;
    qus0[6] = qus0[6] + -wdw2;
    qus1[7] = qus1[7] + -wda2;

    // Quu = B' V B + l_uu, symmetrized through the off-diagonal mean
    float VB0[8], VB1[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      VB0[m] = dt * (V[m][2] + V[m][5]) + V[m][6];
      VB1[m] = dt * V[m][3] + V[m][7];
    }
    const float btvb00 = dt * (VB0[2] + VB0[5]) + VB0[6];
    const float btvb01 = dt * (VB1[2] + VB1[5]) + VB1[6];
    const float btvb10 = dt * VB0[3] + VB0[7];
    const float btvb11 = dt * VB1[3] + VB1[7];
    const float offd = 0.5f * (btvb01 + btvb10);
    const float q00 = btvb00 + luu00;
    const float q11 = btvb11 + luu11;

    float k0, k1, j00, j01, j10, j11;
    boxqp(q00 + mu, offd, offd, q11 + mu, Qu0, Qu1, lb0 - ut0, lb1 - ut1,
          ub0 - ut0, ub1 - ut1, k0, k1, j00, j01, j10, j11);
    float K0[8], K1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      K0[j] = -(j00 * qus0[j] + j01 * qus1[j]);
      K1[j] = -(j10 * qus0[j] + j11 * qus1[j]);
    }

    const float quk0 = q00 * k0 + offd * k1;
    const float quk1 = offd * k0 + q11 * k1;
    const float ku0 = quk0 + Qu0;
    const float ku1 = quk1 + Qu1;
    // Vs_n = Qs + K'(Quu k + Qu) + Qus' k
#pragma unroll
    for (int i = 0; i < 8; ++i)
      Vs[i] = Qs[i] + (K0[i] * ku0 + K1[i] * ku1) +
              (qus0[i] * k0 + qus1[i] * k1);
    // Vss_n = Qss + K'Quu K + K'Qus + (K'Qus)': upper triangle, mirrored
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float kq0 = K0[i] * q00 + K1[i] * offd;
      const float kq1 = K0[i] * offd + K1[i] * q11;
#pragma unroll
      for (int j = i; j < 8; ++j) {
        const float e = Qss[i][j] + kq0 * K0[j] + kq1 * K1[j] +
                        K0[i] * qus0[j] + K1[i] * qus1[j] + K0[j] * qus0[i] +
                        K1[j] * qus1[i];
        V[i][j] = e;
        V[j][i] = e;
      }
    }

    a.ks[(size_t)(t * 2) * B + lane] = k0;
    a.ks[(size_t)(t * 2 + 1) * B + lane] = k1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a.Ks[(size_t)((t * 2) * 8 + j) * B + lane] = K0[j];
      a.Ks[(size_t)((t * 2 + 1) * 8 + j) * B + lane] = K1[j];
    }
    dv1 = dv1 + (k0 * Qu0 + k1 * Qu1);
    dv2 = dv2 + 0.5f * (k0 * quk0 + k1 * quk1);
    const float pg_t = maxf(fabsf(ut0 - clampf(ut0 - Qu0, lb0, ub0)),
                            fabsf(ut1 - clampf(ut1 - Qu1, lb1, ub1)));
    pg = maxf(pg, pg_t);
  }
  a.dv1[lane] = dv1;
  a.dv2[lane] = dv2;
  a.pg[lane] = pg;
}

}  // namespace bwd

extern "C" int mpc_backward_fused_f32(
    const void* ss, const void* us, const void* cf, const void* par,
    const void* Vs, const void* Vss, const void* lb, const void* ub,
    const void* mu, void* ks, void* Ks, void* dv1, void* dv2, void* pg,
    int P, int B, int T, float sign, void* stream) {
  bwd::Args a;
  a.ss = static_cast<const float*>(ss);
  a.us = static_cast<const float*>(us);
  a.cf = static_cast<const float*>(cf);
  a.par = static_cast<const float*>(par);
  a.Vs0 = static_cast<const float*>(Vs);
  a.Vss0 = static_cast<const float*>(Vss);
  a.lb = static_cast<const float*>(lb);
  a.ub = static_cast<const float*>(ub);
  a.mu = static_cast<const float*>(mu);
  a.ks = static_cast<float*>(ks);
  a.Ks = static_cast<float*>(Ks);
  a.dv1 = static_cast<float*>(dv1);
  a.dv2 = static_cast<float*>(dv2);
  a.pg = static_cast<float*>(pg);
  a.P = P;
  a.B = B;
  a.T = T;
  a.sign = sign;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  bwd::backward_fused_kernel<<<blocks, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
