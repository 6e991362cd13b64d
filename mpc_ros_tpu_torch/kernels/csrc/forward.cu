// The fused multi-alpha line search (K5), one Hopper kernel (sm_90a).
//
// Replaces the Pallas TPU kernel mpc_ros_tpu/kernels/forward_pallas.py
// (`_kernel`, launched by `forward_pallas`), the forward half of the legacy
// two-kernel route (SolverConfig.backward="pallas"). The plain PyTorch
// version, with the TPU kernel's operation order, is forward_plain in
// kernels/forward.py.
//
// Bound on this card. Per scenario and launch the function reads ss
// (T+1, 8), us (T, 2), ks (T, 2), Ks (T, 2, 8), the P coefficients, 12
// parameters, lb/ub, cost and act, and writes ss (T+1, 8), us (T, 2), cost
// and accepted: 1,142 floats (4.57 KB) at T = 29, P = 4, so 2.40 GB at
// B = 524,288, >= 0.72 ms at 3.35 TB/s. The arithmetic is ~100 flops per
// candidate and stage plus ~125 per stage of a re-roll (~24k per scenario
// at n_alpha = 8, ~12 GFLOP at that batch, ~0.19 ms at 67 TFLOP/s f32), so
// the function is bound by memory.
//
// Design. One thread owns one scenario; a block is 128 lanes. The n_alpha
// candidate rollouts (alpha = 0.5^j) advance together over t, their
// running states S[a][8] and cost sums in registers (the TPU kernel parked
// them in a VMEM scratch); a template on n_alpha (1..8) unrolls them. Every
// array is batch-minor ([...][lane]), so a warp's 32 accesses of one row
// are consecutive.
//
// - Each knot is read from device memory once. Its 28 rows (ss[t] 8, us[t]
//   2, ks[t] 2, Ks[t] 16) reach the thread through a ring of kStages knots
//   in dynamic shared memory (43,008 B per block), filled by per-thread
//   cp.async copies (async_copy.cuh) two knots ahead, so the loads leave
//   the serial recursion's critical path. No copy crosses threads, so no
//   barrier is needed.
// - The outputs are written during the candidate pass, as the row the lane
//   will most likely keep: an active lane (act = 1) writes candidate 0's
//   rows (alpha = 1) as the blend writes them at upd = 1, new + 0 * old;
//   any other lane writes the pass-through rows, old (ss[t] arrives in the
//   knot as s_b, us[t] as u_b; row t+1 of ss is written at stage t+1, and
//   ss[T] arrives as a last, partial knot).
// - After the acceptance ladder a lane runs a second pass only where those
//   rows are not the answer: active lanes that accepted alpha < 1 re-roll
//   the winner as the TPU kernel does (forward_pallas.py:132-165, the
//   multiply blend upd*new + (1-upd)*old); active lanes that rejected
//   every candidate rewrite the pass-through rows; every other lane is
//   done. The second pass reads the knots through the same ring: with
//   direct loads its serial recursion waited on device memory at every
//   stage, and the pass cost more than the candidate pass it follows.
//   cost and accepted keep the TPU kernel's rule.
//
// Why a lane that skips the re-roll holds what the blend would give it.
// The blend is upd*new + keep*old with upd = accepted * act in {0, 1}.
// (a) upd = 1, alpha = 1: new is the re-roll at alpha_sel = 1, the same
//     operations on the same inputs as candidate 0, and the row written is
//     new + 0*old, the blend's own expression at upd = 1, keep = 0: the
//     same value for every input, non-finite ones included.
// (b) upd = 0 (a rejected lane: the re-roll at alpha_sel = 0, which is not
//     a candidate; or an inactive lane: the re-roll at the winner's alpha):
//     the blend gives 0*new + old, which is old exactly when every element
//     of new and old is finite (0*new is then a zero, and a zero added to
//     old is old; IEEE equality: a zero's sign may differ, -0 == +0), and
//     NaN where new is not. So the lane skips the re-roll only when every
//     rollout at any alpha in [0, 1] is finite, which a bound on the
//     lane's inputs shows: with the controls clipped, |u| <= U =
//     max|lb, ub|; v, theta and e_theta grow by at most U |dt| a stage, so
//     |v| <= V = M + T U |dt| (M the largest |ss| entry, ss[0] included);
//     |x|, |y| <= X = M + T |dt| V; |f(x)| <= F = C P max(1, X)^(P-1) (C
//     the largest |coefficient|); |cte| <= F + X + |sign| V |dt|; so every
//     state entry is at most S = max(V, X, F + X + |sign| V |dt|, U), and
//     the feedback's terms are at most Q = 2 W + 8 G (S + M) (W the largest
//     |us|, |ks| entry, G the largest |Ks| entry). If S and Q are at most
//     1e30 every operation of every rollout is finite (no overflow, no
//     inf - inf, no 0 * inf, no sin of inf): the 1e8 between 1e30 and
//     FLT_MAX covers the rounding of the few thousand operations on the
//     way. A NaN or inf anywhere among those inputs makes S or Q NaN or inf,
//     which fails the test. The weights do not enter the rollouts, only
//     the costs, which the acceptance reads as the TPU kernel does.
// (c) act not in {0, 1}, or the bound failed: the lane re-rolls.
// The optional `second` output records, per lane, the second pass taken
// (0 none, 1 re-roll, 2 pass-through rewrite) plus 4 * the winning
// candidate (n_alpha when none wins).
//
// Reference behaviours kept: the full 8-column K ds sum (K is an input
// here; the megakernel's structural zero in column 4 is not a contract of
// this kernel); the multiply blend; act gates the update, not the
// acceptance flag; exact sinf/cosf (the route has no fast trig); clip and
// min propagate NaN as jnp.clip and torch.clamp do (tiles.cuh). No
// --use_fast_math; nvcc contracts a*b+c into FMAs, so the kernel agrees
// with its plain version to f32 rounding, not bit for bit. Rows are
// addressed by 32-bit offsets (the wrapper checks that 16 T B < 2^31).

#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"
#include "tiles.cuh"

namespace fwd {

using mega::clampf;
using mega::copy_async;
using mega::copy_commit;
using mega::copy_wait;
using mega::kPMax;
using mega::maxf;
using mega::minf;
using mega::polyval;
using mega::ring_base;

// packed-parameter rows (kernels/pack.py)
enum {
  P_WCTE = 0, P_WETH, P_WVEL, P_WANG, P_WACC, P_WDANG, P_WDACC,
  P_RVEL, P_RCTE, P_RETH, P_DT, P_LF, N_PAR
};

constexpr int kTile = 128;
// The knot ring: kStages knots of kKnot floats per thread (row r of stage
// q at ring[(q * kKnot + r) * kTile]): s_b 0-7, u_b 8-9, k 10-11, K 12-27.
constexpr int kStages = 3;
constexpr int kKnot = 28;
constexpr int kRingBytes = kStages * kKnot * kTile * 4;
// the second pass a lane takes (the `second` output's low two bits)
enum { SP_NONE = 0, SP_REROLL = 1, SP_REWRITE = 2 };
// every rollout of a lane whose bound stays below this is finite
constexpr float kFinite = 1e30f;

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
  signed char* second;  // (B,) or null
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

  // Whether every rollout of this lane, at any alpha in [0, 1], is finite
  // (the note's case (b)): m the largest |ss| entry, w the largest |us| or
  // |ks| entry, g the largest |Ks| entry (NaN if any of them is NaN).
  __device__ bool rollouts_finite(float m, float w, float g, int T) const {
    const float U = maxf(maxf(fabsf(lb0), fabsf(lb1)),
                         maxf(fabsf(ub0), fabsf(ub1)));
    const float D = fabsf(dt);
    float C = 0.0f;
#pragma unroll
    for (int i = 0; i < kPMax; ++i)
      if (i < P) C = maxf(C, fabsf(c[i]));
    const float V = m + (float)T * U * D;
    const float X = m + (float)T * D * V;
    const float X1 = maxf(X, 1.0f);
    float F = C * (float)P;
#pragma unroll
    for (int i = 1; i < kPMax; ++i)
      if (i < P) F = F * X1;
    const float S = maxf(maxf(V, X), maxf(F + X + fabsf(sign) * V * D, U));
    const float Q = 2.0f * w + 8.0f * g * (S + m);
    return S <= kFinite && Q <= kFinite;
  }
};

// The thread's view of its lane: base pointers with the lane added once,
// rows addressed by 32-bit multiples of the batch stride B, and its slots
// of the knot ring.
struct Lane {
  const float *ss, *us, *ks, *Ks;
  float* ring;
  int B;
  __device__ __forceinline__ float* stage(int t) const {
    return ring + (t % kStages) * (kKnot * kTile);
  }
  // knot t's rows: ss[t] (8), us[t] (2), and with `gains` ks[t] (2) and
  // Ks[t] (16)
  __device__ __forceinline__ void fetch(int t, bool gains) const {
    float* q = stage(t);
    const int st = t * 8 * B, ut = t * 2 * B, Kt = t * 16 * B;
#pragma unroll
    for (int r = 0; r < 8; ++r) copy_async(q + r * kTile, ss + st + r * B);
#pragma unroll
    for (int m = 0; m < 2; ++m)
      copy_async(q + (8 + m) * kTile, us + ut + m * B);
    if (!gains) return;
#pragma unroll
    for (int m = 0; m < 2; ++m)
      copy_async(q + (10 + m) * kTile, ks + ut + m * B);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      copy_async(q + (12 + j) * kTile, Ks + Kt + j * B);
  }
  // the last, partial knot: ss[T] alone
  __device__ __forceinline__ void fetch_last(int T) const {
    float* q = stage(T);
    const int st = T * 8 * B;
#pragma unroll
    for (int r = 0; r < 8; ++r) copy_async(q + r * kTile, ss + st + r * B);
  }
  // knot t (ss alone when t = T) goes out, closing one copy group
  __device__ __forceinline__ void prefetch(int t, int T,
                                           bool gains = true) const {
    if (t < T)
      fetch(t, gains);
    else if (t == T)
      fetch_last(T);
    copy_commit();
  }
};

template <int NA>
__global__ void __launch_bounds__(kTile) forward_kernel(const Args a) {
  const int lane = blockIdx.x * kTile + threadIdx.x;
  if (lane >= a.B) return;
  const int B = a.B;
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
  // the rows written in the candidate pass: candidate 0's, or old
  const bool spec_new = act == 1.0f;

  const Lane L{a.ss + lane, a.us + lane, a.ks + lane, a.Ks + lane,
               ring_base() + threadIdx.x, B};
  float* const ss_out = a.ss_out + lane;
  float* const us_out = a.us_out + lane;

  // ---- the NA candidate rollouts, advancing together over t ----
  float S[NA][8], accs[NA];
  // the largest |ss|, |us| or |ks|, and |Ks| entries (the bound)
  float m_s = 0.0f, m_w = 0.0f, m_g = 0.0f;
  L.prefetch(0, T);
  L.prefetch(1, T);
  for (int t = 0; t < T; ++t) {
    // knot t+2 goes out; knot t has arrived
    L.prefetch(t + 2, T);
    copy_wait<2>();
    const float* q = L.stage(t);
    float s_b[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) s_b[r] = q[r * kTile];
    const float ub_0 = q[8 * kTile], ub_1 = q[9 * kTile];
    const float k0 = q[10 * kTile], k1 = q[11 * kTile];
    float K0[8], K1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      K0[j] = q[(12 + j) * kTile];
      K1[j] = q[(20 + j) * kTile];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) m_s = maxf(m_s, fabsf(s_b[r]));
    m_w = maxf(m_w, maxf(maxf(fabsf(ub_0), fabsf(ub_1)),
                         maxf(fabsf(k0), fabsf(k1))));
#pragma unroll
    for (int j = 0; j < 8; ++j)
      m_g = maxf(m_g, maxf(fabsf(K0[j]), fabsf(K1[j])));
    if (t == 0) {
#pragma unroll
      for (int al = 0; al < NA; ++al) {
#pragma unroll
        for (int r = 0; r < 8; ++r) S[al][r] = s_b[r];
        accs[al] = 0.0f;
      }
    }
    // row t of ss: s0 at t = 0, as the blend writes it
    const bool new_row = spec_new && t > 0;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      ss_out[(t * 8 + r) * B] = new_row ? S[0][r] + 0.0f * s_b[r] : s_b[r];
    const float rate = t >= 1 ? 1.0f : 0.0f;
#pragma unroll
    for (int al = 0; al < NA; ++al) {
      const float alpha = 1.0f / (float)(1 << al);
      float u0, u1;
      pr.feedback(S[al], s_b, ub_0, ub_1, alpha, k0, k1, K0, K1, u0, u1);
      if (al == 0) {
        us_out[(t * 2) * B] = spec_new ? u0 + 0.0f * ub_0 : ub_0;
        us_out[(t * 2 + 1) * B] = spec_new ? u1 + 0.0f * ub_1 : ub_1;
      }
      accs[al] = accs[al] + pr.stage_cost(S[al], u0, u1, rate);
      pr.step(S[al], u0, u1);
    }
  }
  // ss[T], the last partial knot
  copy_wait<0>();
  {
    const float* q = L.stage(T);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float old = q[r * kTile];
      m_s = maxf(m_s, fabsf(old));
      ss_out[(T * 8 + r) * B] = spec_new ? S[0][r] + 0.0f * old : old;
    }
  }

  // ---- acceptance: the first (largest) alpha that lowers the cost ----
  float picked = 0.0f, alpha_sel = 0.0f, cost_sel = cost_prev;
  int winner = NA;
#pragma unroll
  for (int al = 0; al < NA; ++al) {
    const float cost_a = accs[al] + pr.term_cost(S[al]);
    const float improved = cost_a < cost_prev ? 1.0f : 0.0f;
    const float take = improved * (1.0f - minf(picked, 1.0f));
    picked = picked + take;
    alpha_sel = alpha_sel + take * (1.0f / (float)(1 << al));
    cost_sel = take > 0.5f ? cost_a : cost_sel;
    winner = take > 0.5f ? al : winner;
  }
  const float accepted = minf(picked, 1.0f);
  const float upd = accepted * act;  // only active lanes move
  const float keep = 1.0f - upd;
  a.cost_out[lane] = upd > 0.5f ? cost_sel : cost_prev;
  a.acc_out[lane] = accepted;

  // ---- the second pass, only where the rows written are not the answer
  const bool finite = pr.rollouts_finite(m_s, m_w, m_g, T);
  int kind;
  if (act == 1.0f)
    kind = accepted == 1.0f ? (alpha_sel == 1.0f ? SP_NONE : SP_REROLL)
                            : (finite ? SP_REWRITE : SP_REROLL);
  else
    kind = act == 0.0f && finite ? SP_NONE : SP_REROLL;
  if (a.second != nullptr)
    a.second[lane] = static_cast<signed char>(kind + 4 * winner);

  if (kind == SP_NONE) return;
  // Rejected active lanes rewrite the pass-through rows; re-rolling lanes
  // roll the winner again from s0 and write through the mask. Both read
  // the knots through the ring as the candidate pass does (a rewrite only
  // the rows of ss and us), row t of ss at stage t.
  const bool reroll = kind == SP_REROLL;
  float sa[8];
  L.prefetch(0, T, reroll);
  L.prefetch(1, T, reroll);
  for (int t = 0; t < T; ++t) {
    L.prefetch(t + 2, T, reroll);
    copy_wait<2>();
    const float* q = L.stage(t);
    float s_b[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) s_b[r] = q[r * kTile];
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r) sa[r] = s_b[r];
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r)
        ss_out[(t * 8 + r) * B] =
            reroll ? upd * sa[r] + keep * s_b[r] : s_b[r];
    }
    const float ub_0 = q[8 * kTile], ub_1 = q[9 * kTile];
    float u0 = ub_0, u1 = ub_1;
    if (reroll) {
      float K0[8], K1[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        K0[j] = q[(12 + j) * kTile];
        K1[j] = q[(20 + j) * kTile];
      }
      pr.feedback(sa, s_b, ub_0, ub_1, alpha_sel, q[10 * kTile],
                  q[11 * kTile], K0, K1, u0, u1);
      pr.step(sa, u0, u1);
      u0 = upd * u0 + keep * ub_0;
      u1 = upd * u1 + keep * ub_1;
    }
    us_out[(t * 2) * B] = u0;
    us_out[(t * 2 + 1) * B] = u1;
  }
  copy_wait<0>();
  const float* q = L.stage(T);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float old = q[r * kTile];
    ss_out[(T * 8 + r) * B] = reroll ? upd * sa[r] + keep * old : old;
  }
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
                               void* acc_out, void* second, int P, int B,
                               int T, float sign, int n_alpha,
                               void* stream) {
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
  a.second = static_cast<signed char*>(second);
  a.P = P;
  a.B = B;
  a.T = T;
  a.sign = sign;
  const int blocks = (B + fwd::kTile - 1) / fwd::kTile;
  // the knot ring's dynamic shared memory (under the 48 KB default)
  fwd::forward_kernel<FWD_NALPHA>
      <<<blocks, fwd::kTile, fwd::kRingBytes,
         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// What this build occupies on the current device: out = (registers per
// thread, local memory bytes per thread, dynamic shared memory bytes per
// block, resident blocks per SM at that shared memory).
extern "C" int mpc_forward_occupancy(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, fwd::forward_kernel<FWD_NALPHA>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fwd::forward_kernel<FWD_NALPHA>, fwd::kTile,
      fwd::kRingBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = fwd::kRingBytes;
  out[3] = blocks;
  return 0;
}

extern "C" const char* mpc_cuda_error_string(int err) {
  if (err == FWD_ERR_VARIANT)
    return "library built for another n_alpha";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
