// The whole batched SQP solve in one Hopper kernel (sm_90a).
//
// Replaces the Pallas TPU megakernel mpc_ros_tpu/kernels/solve_pallas.py
// (`_kernel`, launched by `solve_pallas`). The plain PyTorch version, with
// the same operation order, is solve_mega_plain in kernels/solve_mega.py.
//
// Design. One thread owns one scenario and runs its complete control-
// limited SQP loop: the initial rollout, then per iteration the inline-
// linearized Riccati backward scan (gated GN->DDP terms, exact 2-D box QP
// per stage), n_ls parallel line-search rollouts that record each
// candidate's clamped controls, the winner's re-roll and the per-lane mu /
// convergence / stall bookkeeping. The per-tile early exit of the TPU
// kernel becomes, at done_frac = 1, a per-thread `while (it < max_iters &&
// !done)`; that is exact, because a done lane never updates, so its result
// does not depend on which lanes share its tile. Under done_frac < 1
// (template flag TILE_EXIT) a block of kTile threads is one tile: its
// threads iterate in lockstep, a done thread skips the body, and at the top
// of every iteration `__syncthreads_count(done)` stops the whole block once
// n_done_needed of its lanes are done. No thread leaves that loop on its
// own, so every thread reaches every barrier. The card starts a launch's
// blocks in index order, so the tiles that run last, on which the SMs
// wait while the launch drains, are the batch's last; block b solves tile
// (b + tile_shift) mod tiles instead, with a shift the launcher changes
// from launch to launch (solve_mega.tile_shift), so that which tiles run
// last is not fixed by the batch's layout. A tile's lanes and result do
// not depend on the block that runs it. An optional resume state
// (done, conv, mu, gnorm) replaces the cold start of the loop state, as the
// TPU kernel's `has_resume` does; the schedules (solve_mega.py) run the
// sorted and compact two-pass solves with it.
//
// One thread per lane, a warp runs to its slowest lane and a block to its
// slowest warp. At done_frac = 1 a batch of many lanes per resident thread
// whose tiles wait long on their slowest lanes runs instead on a
// persistent grid (solve_mega.refill_slots, grid_pays; grid_loop):
// as many threads (slots) as the card holds at once, each taking the next
// unsolved lane from a counter when its lane is done, one SQP iteration per
// trip of a loop whose phases the warp's threads run together whatever
// lane each holds. A lane's result does not depend on the thread that ran
// it, so the outputs are the per-thread grid's bit for bit. The working set
// (trajectory and scratch) is indexed by slot with stride slots, so that a
// warp's rows stay coalesced when its lanes are scattered; the outputs are
// lane-major, written by the exit's backward a whole row of a lane at a
// time. The only result that depends on the tile, the blend of a done lane
// for as long as its tile runs, is settled by a second kernel that solves
// again every tile the first recorded as outliving such a lane. The grid
// codes the iteration apart, as the phases of `Solve`, the same operations
// in the same order: built from those phases, the one-lane-per-thread
// kernel ran 2-5% slower on the setpoint variant and on small batches
// (H100), so it keeps its own single function and register allocation,
// and the tests hold the two bit for bit.
//
// Three more template flags carry the TPU kernel's remaining static
// specializations. BLOBS adds Gaussian obstacles, sum_k w exp(-|d|^2 g),
// to every knot's cost, and their gradient and Gauss-Newton curvature
// (with the concave -2 g v I part on lanes past the DDP gate) to the
// backward's stage and terminal expansions; the number of blobs is a
// runtime count and the lane-major (K, B) parameters are read from global
// memory where they are used (coalesced, L1-resident), not held in
// registers. SETP reads knot t's (ref_cte, ref_etheta, ref_vel) from a
// (T+1, 3, B) profile instead of the per-lane scalars. BICYCLE advances
// the heading by v delta dt / lf: A[2,3] = A[5,3] = delta dt / lf, B rows
// 2 and 5 scale by v / lf, gated DDP adds the (v, delta) cross term to
// Qus[0,3], and fast trig runs its Taylor series on the half angle and
// composes by the double-angle step (the increment has no configured
// bound).
//
// Memory. Every array is batch-minor, [...][lane], so a warp's 32 loads and
// stores of one row are consecutive addresses; each thread adds its lane to
// the base pointers once and addresses rows by 32-bit multiples of B. The
// trajectory has one buffer, the outputs themselves: rows 0-5 of ss
// (T+1, 8, B) and us (T, 2, B); rows 6-7 of ss (the previous control) are
// filled once at the end. Scratch: traj_g (T, 4, B), the rollout's trig
// cache; ks (T, 2, B) and Ks (T, 2, 7, B), the gains without K's
// structurally zero column 4; cand_u (n_ls, T, 2, B), the line search's
// clamped controls. The re-roll replays the winner's recorded controls
// from s0 and writes s, u and g in place; a lane whose step is not
// accepted skips it. That is the TPU kernel's re-roll, u_b + alpha_sel k +
// K ds recomputed and blended upd * new + (1 - upd) * old
// (solve_pallas.py:692-720), exactly, as long as every row the backward
// read (s, u) or wrote (k, K) is finite: alpha_sel is one of the
// candidates' alphas and the candidate's state took the same steps, so
// the recomputed control is the recorded one bit for bit (the plain
// version recomputes it; tests/test_torch_reroll.py), new + 0 * old is new
// and, on a rejected step, the re-roll at alpha 0 rebuilds old, so 0 * new
// + old is old. The backward keeps a running sum of those rows (`chk`,
// `replay_check` in the plain module), finite only if each is; where it is
// not (a lane with NaN, inf or an overflowing rollout) the lane runs the
// TPU kernel's recompute and blend (reroll_blend), whose 0 * inf gives the
// plain version's NaN (tests/test_torch_k1_nonfinite.py). A lane that is
// done keeps its state, unless its trajectory or its last backward's rows
// were not finite (`dirt`), or the backward it would run next is not (the
// probe): such a lane goes on blending with upd = 0, as the TPU kernel and
// the plain version do within their tile, while its block runs (the
// design's note above the SQP loop). Counted per knot and
// SQP iteration, the scratch traffic is 74 floats at n_ls = 4 (82 at 8):
// the backward reads s, u, g (12) and writes k, K (16); the line search
// reads s, u, k, K (24) and writes n_ls x 2 controls; the re-roll reads 2
// and writes 12, on accepted lanes only (solve_mega.scratch_bytes). At
// T = 29 that is 8.6 KB per lane-iteration, 7.0 KB when the step is
// rejected (the earlier double-buffered design streamed 106 floats, 12.3
// KB, on every lane-iteration).
//
// The knot rows reach the threads through a ring of kStages knots in
// dynamic shared memory (kRingRows floats per knot and thread), filled by
// per-thread asynchronous copies (async_copy.cuh): the backward prefetches
// knots t-1 and t-2 while it computes knot t (u_{t-1} comes from knot
// t-1's row, not from a second load), the line search knots t+1 and t+2.
// A copy needs no barrier between threads, so the per-thread exit stays
// exact; the lockstep variant uses the same per-thread copies (its done
// threads skip the body, so the block never copies a row together).
//
// What bounds it on this card: the scratch traffic above (the arithmetic
// intensity is ~4 counted operations per byte, under the card's ridge of
// ~20), the latency of a serial per-lane recursion at 8-12 resident warps
// per SM, and, one thread per lane, a warp running to its slowest lane: at
// the cfg's weights a batch sorted by its lanes' iterations solves in 55%
// of the unsorted batch's time (H100). The persistent grid recovers part
// of that. Its trips cost ~1.5x an iteration of the sorted batch: a trip's
// backward runs slower over the grid's fixed working set than over the
// one-thread-per-lane grid's, the exit's row writes and the turnover of
// lanes (loads, initial rollouts) ride in every trip, and the batch drains
// at the end. It pays where a batch's lanes' iterations vary widely (the
// benchmark's cold batch: -15% of K1's time at 524,288 lanes) and costs
// where they vary little (warm starts, softer weights: +12% to +18%), so
// the launcher takes it only where the last call of the same shape read
// so (solve_mega.grid_pays). Vs, the value Hessian
// (its 28 live entries: row/column 4 is structurally diag(wc2)), K, Qus
// and the n_ls candidate states stay in registers; the template on (n_ls,
// ddp, fast trig, adaptive weight scale) lets the 8x8 algebra unroll
// (`-Xptxas -v` reports registers and spills in the build log). Tensor
// cores and TMA tensor maps do not apply: each lane's 8x8 Riccati algebra
// shares no operand with another lane, so there is no product for wgmma,
// and a knot's rows are one word per lane.
//
// Each option's code sits in `if constexpr` blocks beside the statements
// it replaces, and its arguments at the end of Args. Numerics follow the
// reference kernel: the zero previous control at t = 0 is a select, never
// a multiply; trig "exact" is sinf/cosf; the blobs' exponentials are expf;
// the QP's three reciprocals are IEEE divisions (no --use_fast_math). The
// build passes -fmad=false (kernels/_build.py), so no a*b + c is contracted
// into an FMA and every product and sum rounds as in the plain version,
// which computes in the same order: the two agree bit for bit but for the
// transcendentals (sinf/cosf/expf against PyTorch's), whose last-bit
// differences the iterations can carry to solver tolerance. With FMA
// contraction the two parted at rounding-level decisions (an acceptance,
// a box-QP clamp, a convergence test) on a few lanes in 10^5, and which
// lanes moved with every change of the code around them.

#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"
#include "tiles.cuh"

namespace mega {

// One block is one tile of lanes (solve_mega.TILE in the wrapper).
constexpr int kTile = 128;
// The knot ring: kStages knots of kRingRows floats per thread. A backward
// knot is s (6), u (2) and the trig cache g (4); a line-search knot is s
// (6), u (2), k (2) and K without its zero column (14).
constexpr int kStages = 3;
constexpr int kRingRows = 24;
constexpr int kRingBytes = kStages * kRingRows * kTile * 4;
// A rollout's controls load this many knots at a time: on the persistent
// grid, where a fresh lane's initial rollout reads them from the batch, and
// one thread per lane.
constexpr int kChunk = 16;

// packed-parameter rows (kernels/pack.py)
enum {
  P_WCTE = 0, P_WETH, P_WVEL, P_WANG, P_WACC, P_WDANG, P_WDACC,
  P_RVEL, P_RCTE, P_RETH, P_DT, P_LF, N_PAR
};

struct Args {
  const float* z0;    // (6, B)
  const float* cf;    // (P, B)
  const float* par;   // (12, B)
  const float* lb;    // (2, B)
  const float* ub;    // (2, B)
  const float* u0;    // (T, 2, B)
  const float* resume;  // (4, B): done, conv, mu, gnorm; or null
  float* ss;          // (T+1, 8, B) out; rows 0-5 are the trajectory
  float* us;          // (T, 2, B) out; the trajectory's controls
  float* cost;        // (B,) out
  float* conv;
  float* iters;
  float* gnorm;
  float* mu;
  float* done;
  float* diag;        // (NLS + 2, B): candidate costs, cost before, alpha;
                      // or null
  float* traj_g;      // (T, 4, B) scratch
  float* ks;          // (T, 2, B)
  float* Ks;          // (T, 2, 7, B)
  float* cand_u;      // (NLS, T, 2, B)
  int P, B, T, max_iters, n_done_needed;
  int tile_shift;  // TILE_EXIT: block b solves tile (b + tile_shift) % tiles
  float sign, tol_grad, tol_cost_eff, mu_min, mu_max, mu_factor, ddp_gate;
  const float* setp;  // (T+1, 3, B) per-knot setpoints (SETP)
  const float *bx, *by, *bg, *bw;  // (n_blobs, B) each (BLOBS)
  int n_blobs;
  // the persistent grid (slots > 0 threads): the slot-indexed working set
  // (see by_slot) and the launch's counters and tile marks (see kHead)
  float* work;
  int* tiles;
  int slots;
};

// The thread's view of its lane's working set: base pointers with the lane
// (or the slot) added once, rows addressed by 32-bit multiples of the
// stride B (the batch, or the slots), and its slots of the knot ring (row r
// of stage q at ring[(q * kRingRows + r) * kTile]).
struct Lane {
  float *s, *u, *g, *k, *K, *cu;
  float* ring;
  int B, T;
  __device__ __forceinline__ float* stage(int t) const {
    return ring + (t % kStages) * (kRingRows * kTile);
  }
  // knot t's backward rows: s (6), u (2), g (4)
  __device__ __forceinline__ void fetch_bwd(int t) const {
    float* q = stage(t);
    const int st = t * 8 * B, ut = t * 2 * B, gt = t * 4 * B;
#pragma unroll
    for (int r = 0; r < 6; ++r) copy_async(q + r * kTile, s + st + r * B);
#pragma unroll
    for (int m = 0; m < 2; ++m)
      copy_async(q + (6 + m) * kTile, u + ut + m * B);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      copy_async(q + (8 + r) * kTile, g + gt + r * B);
  }
  // knot t's line-search rows: s (6), u (2), k (2), K (14)
  __device__ __forceinline__ void fetch_ls(int t) const {
    float* q = stage(t);
    const int st = t * 8 * B, ut = t * 2 * B, Kt = t * 14 * B;
#pragma unroll
    for (int r = 0; r < 6; ++r) copy_async(q + r * kTile, s + st + r * B);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      copy_async(q + (6 + m) * kTile, u + ut + m * B);
      copy_async(q + (8 + m) * kTile, k + ut + m * B);
    }
#pragma unroll
    for (int j = 0; j < 14; ++j)
      copy_async(q + (10 + j) * kTile, K + Kt + j * B);
  }
  // a rollout's step at knot t, in place: u(t), g(t) and s(t+1)
  __device__ __forceinline__ void put(int t, float u0, float u1, float ct,
                                      float st, float se, float ce,
                                      const float (&sn)[8]) const {
    u[t * 2 * B] = u0;
    u[(t * 2 + 1) * B] = u1;
    float* gt = g + t * 4 * B;
    gt[0] = ct;
    gt[B] = st;
    gt[2 * B] = se;
    gt[3 * B] = ce;
    float* sp = s + (t + 1) * 8 * B;
#pragma unroll
    for (int r = 0; r < 6; ++r) sp[r * B] = sn[r];
  }
};

// Per-scenario constants of the cost and dynamics.
struct Problem {
  float c[kPMax];
  int P;
  float dt, sign;
  float wcte, weth, wvel, wang, wacc, wdang, wdacc;
  float rc, re, rv;

  __device__ void dyn_step(const float (&s)[8], float u0, float u1, float ct,
                           float st, float se, float (&sn)[8]) const {
    const float f0 = polyval(c, P, s[0]);
    const float dth = u0 * dt;
    sn[0] = s[0] + s[3] * ct * dt;
    sn[1] = s[1] + s[3] * st * dt;
    sn[2] = s[2] + dth;
    sn[3] = s[3] + u1 * dt;
    sn[4] = (f0 - s[1]) + sign * s[3] * se * dt;
    sn[5] = s[5] + dth;
    sn[6] = u0;
    sn[7] = u1;
  }

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
};

// The lane's view of the options' inputs: the setpoint profile (SETP), the
// blobs (BLOBS) and the bicycle's 1 / lf (BICYCLE); the pointers carry the
// lane.
struct Extras {
  const float *setp, *bx, *by, *bg, *bw;
  int n_blobs;
  int B;
  float invlf;

  // knot t's (ref_cte, ref_etheta, ref_vel)
  __device__ void ref(int t, float& rc, float& re, float& rv) const {
    const float* r = setp + t * 3 * B;
    rc = r[0];
    re = r[B];
    rv = r[2 * B];
  }

  // sum_k w exp(-|d|^2 g)
  __device__ float obs_val(float x, float y) const {
    float tot = 0.0f;
    for (int k = 0; k < n_blobs; ++k) {
      const int i = k * B;
      const float dx = x - bx[i];
      const float dy = y - by[i];
      tot = tot + bw[i] * expf(-(dx * dx + dy * dy) * bg[i]);
    }
    return tot;
  }

  // gradient and Gauss-Newton curvature of the blobs; with GATE the
  // concave -2 g v I part is added back scaled by the lane's DDP gate
  template <bool GATE>
  __device__ void obs_terms(float x, float y, float gate, float& gx,
                            float& gy, float& hxx, float& hxy,
                            float& hyy) const {
    gx = gy = hxx = hxy = hyy = 0.0f;
    for (int k = 0; k < n_blobs; ++k) {
      const int i = k * B;
      const float dx = x - bx[i];
      const float dy = y - by[i];
      const float g = bg[i];
      const float v = bw[i] * expf(-(dx * dx + dy * dy) * g);
      const float tg = 2.0f * g;
      gx = gx - tg * dx * v;
      gy = gy - tg * dy * v;
      const float s = tg * tg * v;
      hxx = hxx + s * dx * dx;
      hxy = hxy + s * dx * dy;
      hyy = hyy + s * dy * dy;
      if (GATE) {
        hxx = hxx - gate * tg * v;
        hyy = hyy - gate * tg * v;
      }
    }
  }

  // the bicycle's heading increment v delta dt / lf and its step
  __device__ void bicycle_step(const Problem& pr, const float (&s)[8],
                               float u0, float u1, float ct, float st,
                               float se, float (&sn)[8]) const {
    const float f0 = polyval(pr.c, pr.P, s[0]);
    const float dth = s[3] * invlf * u0 * pr.dt;
    sn[0] = s[0] + s[3] * ct * pr.dt;
    sn[1] = s[1] + s[3] * st * pr.dt;
    sn[2] = s[2] + dth;
    sn[3] = s[3] + u1 * pr.dt;
    sn[4] = (f0 - s[1]) + pr.sign * s[3] * se * pr.dt;
    sn[5] = s[5] + dth;
    sn[6] = u0;
    sn[7] = u1;
  }
};

// Rollout trigonometry. Every rollout starts from the same pinned s0 and
// theta / etheta advance by the same u0*dt, so etheta_t = theta_t + phi
// with phi fixed for the whole solve. FAST carries cos/sin(theta) by
// rotation composition: a 9th/8th-order Taylor increment plus one Newton
// renormalization, with the constants as the reference's f32 values. HALF
// (the bicycle) runs the series on the half increment and squares the
// rotation by the double-angle step: accurate through |d| = 2 rad/step.
template <bool FAST, bool HALF = false>
struct Trig {
  float cphi, sphi;
  __device__ float se(float ct, float st, float eth) const {
    return FAST ? st * cphi + ct * sphi : sinf(eth);
  }
  __device__ float ce(float ct, float st, float eth) const {
    return FAST ? ct * cphi - st * sphi : cosf(eth);
  }
  __device__ void step(float& ct, float& st, float d, float th_next) const {
    if constexpr (FAST && HALF) {
      const float h = d * 0.5f;
      const float z = h * h;
      const float sh =
          h * (1.0f +
               z * ((float)(-1.0 / 6.0) +
                    z * ((float)(1.0 / 120.0) +
                         z * ((float)(-1.0 / 5040.0) +
                              z * (float)(1.0 / 362880.0)))));
      const float ch =
          1.0f + z * (-0.5f + z * ((float)(1.0 / 24.0) +
                                   z * ((float)(-1.0 / 720.0) +
                                        z * (float)(1.0 / 40320.0))));
      const float cd = ch * ch - sh * sh;
      const float sd = 2.0f * sh * ch;
      const float c2 = ct * cd - st * sd;
      const float s2 = st * cd + ct * sd;
      const float f = 1.5f - 0.5f * (c2 * c2 + s2 * s2);
      ct = c2 * f;
      st = s2 * f;
    } else if (FAST) {
      const float z = d * d;
      const float sd =
          d * (1.0f +
               z * ((float)(-1.0 / 6.0) +
                    z * ((float)(1.0 / 120.0) +
                         z * ((float)(-1.0 / 5040.0) +
                              z * (float)(1.0 / 362880.0)))));
      const float cd =
          1.0f + z * (-0.5f + z * ((float)(1.0 / 24.0) +
                                   z * ((float)(-1.0 / 720.0) +
                                        z * (float)(1.0 / 40320.0))));
      const float c2 = ct * cd - st * sd;
      const float s2 = st * cd + ct * sd;
      const float f = 1.5f - 0.5f * (c2 * c2 + s2 * s2);
      ct = c2 * f;
      st = s2 * f;
    } else {
      ct = cosf(th_next);
      st = sinf(th_next);
    }
  }
};

// Closed-loop control of a rollout at knot t: u = u_b + alpha k + K ds,
// clipped. K column 4 is structurally zero; the sum runs over
// j = 0, 1, 2, 3, 5, 6, 7 in that order.
__device__ __forceinline__ float feedback(float ub, float alpha, float k,
                                          const float (&Km)[8],
                                          const float (&ds)[8]) {
  float sum = Km[0] * ds[0];
  sum = sum + Km[1] * ds[1];
  sum = sum + Km[2] * ds[2];
  sum = sum + Km[3] * ds[3];
  sum = sum + Km[5] * ds[5];
  sum = sum + Km[6] * ds[6];
  sum = sum + Km[7] * ds[7];
  return ub + alpha * k + sum;
}

// a lane's element of an optional (., B) input, or null
__device__ __forceinline__ const float* at(const float* p, int lane) {
  return p == nullptr ? nullptr : p + lane;
}

// The largest finite float: the replay check's sum is finite iff it is at
// most this in magnitude (NaN compares false).
constexpr float kFloatMax = 3.40282347e38f;

// Rows 0-5 of a state and the two controls of a knot, summed in a fixed
// order: finite only if each is (a finite sum's overflow also reads as not
// finite, which only sends a lane down the plain version's own path).
__device__ __forceinline__ float row_sum(const float (&s)[8], float u0,
                                         float u1) {
  return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (u0 + u1));
}

// The TPU kernel's re-roll (solve_pallas.py:692-720), run on a lane whose
// replay check failed: per knot, u = clip(u_b + alpha_sel k + K ds), the
// step from the re-roll's own state, and the blend upd * new + (1 - upd) *
// old of the control, the trig cache and the next state, in place (the old
// knot t+1 is read before it is written and carried as the next stage's
// base). The operations and their order are the plain version's, so a
// non-finite row turns to NaN exactly where it does there. Returns the sum
// of the trajectory it leaves (s0 and every row written), finite only if
// each row is.
template <bool BICYCLE, class TrigT>
__device__ __forceinline__ float reroll_blend(const Lane& L, const Problem& pr,
                                          const Extras& ex, const TrigT& trig,
                                          const float (&s0)[8], float ct00,
                                          float st00, float alpha_sel,
                                          float upd, float lb0, float lb1,
                                          float ub0, float ub1) {
  const int B = L.B;
  const float keep = 1.0f - upd;
  float sa[8], sb[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) sa[r] = s0[r];
#pragma unroll
  for (int r = 0; r < 6; ++r) sb[r] = L.s[r * B];
  sb[6] = 0.0f;
  sb[7] = 0.0f;
  float ct = ct00, st = st00;
  float sum = row_sum(s0, 0.0f, 0.0f);
  for (int t = 0; t < L.T; ++t) {
    const float ub_0 = L.u[t * 2 * B], ub_1 = L.u[(t * 2 + 1) * B];
    const float k0 = L.k[t * 2 * B], k1 = L.k[(t * 2 + 1) * B];
    float Km0[8], Km1[8], ds[8];
    const float* Kt = L.K + t * 14 * B;
#pragma unroll
    for (int j = 0, jj = 0; j < 8; ++j) {
      if (j == 4) {
        Km0[j] = Km1[j] = 0.0f;
        continue;
      }
      Km0[j] = Kt[jj * B];
      Km1[j] = Kt[(7 + jj) * B];
      ++jj;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) ds[j] = sa[j] - sb[j];
    const float u0 = clampf(feedback(ub_0, alpha_sel, k0, Km0, ds), lb0, ub0);
    const float u1 = clampf(feedback(ub_1, alpha_sel, k1, Km1, ds), lb1, ub1);
    const float se = trig.se(ct, st, sa[5]);
    const float ce = trig.ce(ct, st, sa[5]);
    float* gt = L.g + t * 4 * B;
    gt[0] = upd * ct + keep * gt[0];
    gt[B] = upd * st + keep * gt[B];
    gt[2 * B] = upd * se + keep * gt[2 * B];
    gt[3 * B] = upd * ce + keep * gt[3 * B];
    float sn[8];
    if constexpr (BICYCLE)
      ex.bicycle_step(pr, sa, u0, u1, ct, st, se, sn);
    else
      pr.dyn_step(sa, u0, u1, ct, st, se, sn);
    const float un0 = upd * u0 + keep * ub_0;
    const float un1 = upd * u1 + keep * ub_1;
    L.u[t * 2 * B] = un0;
    L.u[(t * 2 + 1) * B] = un1;
    float* sp = L.s + (t + 1) * 8 * B;
    float sw[8];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const float old = sp[r * B];
      sw[r] = upd * sn[r] + keep * old;
      sp[r * B] = sw[r];
      sb[r] = old;
    }
    sum = sum + row_sum(sw, un0, un1);
    sb[6] = ub_0;
    sb[7] = ub_1;
    if constexpr (BICYCLE)
      trig.step(ct, st, sa[3] * ex.invlf * u0 * pr.dt, sn[2]);
    else
      trig.step(ct, st, u0 * pr.dt, sn[2]);
#pragma unroll
    for (int r = 0; r < 8; ++r) sa[r] = sn[r];
  }
  return sum;
}

// One lane per thread (the batch's lanes over blocks of kTile threads):
// the lane's whole SQP loop, its trajectory in place in the outputs.
template <int NLS, bool DDP, bool FAST, bool ADAPT, bool TILE_EXIT,
          bool BLOBS, bool SETP, bool BICYCLE>
__device__ __forceinline__ void lane_loop(const Args& a) {
  const int tile =
      TILE_EXIT ? (blockIdx.x + a.tile_shift) % gridDim.x : blockIdx.x;
  const int lane_i = tile * blockDim.x + threadIdx.x;
  // under TILE_EXIT the launcher takes B % kTile == 0 only, so no thread
  // of a block returns here and misses the block's barriers
  if (lane_i >= a.B) return;
  const int B = a.B;
  const int T = a.T;
  const Lane L{a.ss + lane_i, a.us + lane_i, a.traj_g + lane_i,
               a.ks + lane_i, a.Ks + lane_i, a.cand_u + lane_i,
               ring_base() + threadIdx.x, B, T};

  float par[N_PAR];
#pragma unroll
  for (int r = 0; r < N_PAR; ++r) par[r] = a.par[r * B + lane_i];
  Problem pr;
  pr.P = a.P;
#pragma unroll
  for (int i = 0; i < kPMax; ++i)
    pr.c[i] = i < a.P ? a.cf[i * B + lane_i] : 0.0f;
  const float dt = par[P_DT];
  const float sign = a.sign;
  pr.dt = dt;
  pr.sign = sign;
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
  Extras ex{at(a.setp, lane_i), at(a.bx, lane_i), at(a.by, lane_i),
            at(a.bg, lane_i), at(a.bw, lane_i), a.n_blobs, B, 0.0f};
  if constexpr (BICYCLE) ex.invlf = 1.0f / par[P_LF];
  const float lb0 = a.lb[lane_i], lb1 = a.lb[B + lane_i];
  const float ub0 = a.ub[lane_i], ub1 = a.ub[B + lane_i];

  const float wv2 = 2.0f * pr.wvel;
  const float wc2 = 2.0f * pr.wcte;
  const float we2 = 2.0f * pr.weth;
  const float ww2 = 2.0f * pr.wang;
  const float wa2 = 2.0f * pr.wacc;
  // one-sided weight-scale equivariance: s = max(1, sum(w)/470) scales the
  // mu floor/ceiling and the relative-cost guards; pg is measured as 1/s
  float wscl, inv_wscl, mu_lo, mu_hi;
  if (ADAPT) {
    wscl = maxf((pr.wcte + pr.weth + pr.wvel + pr.wang + pr.wacc +
                 pr.wdang + pr.wdacc) * (float)(1.0 / 470.0),
                1.0f);
    inv_wscl = 1.0f / wscl;
    mu_lo = a.mu_min * wscl;
    mu_hi = a.mu_max * wscl;
  } else {
    wscl = 1.0f;
    inv_wscl = 1.0f;
    mu_lo = a.mu_min;
    mu_hi = a.mu_max;
  }

  float s0[8];
#pragma unroll
  for (int r = 0; r < 6; ++r) s0[r] = a.z0[r * B + lane_i];
  s0[6] = 0.0f;
  s0[7] = 0.0f;
  const float ct00 = cosf(s0[2]);
  const float st00 = sinf(s0[2]);
  Trig<FAST, BICYCLE> trig{1.0f, 0.0f};
  if (FAST) {
    const float phi = s0[5] - s0[2];
    trig.cphi = cosf(phi);
    trig.sphi = sinf(phi);
  }

  // ---------------- initial rollout ------------------------------------
#pragma unroll
  for (int r = 0; r < 6; ++r) L.s[r * B] = s0[r];
  float cost;
  // `dirt`: finite only if the lane's trajectory (rows 0-5 of s and the
  // controls) and the rows its last backward read and wrote are; a done
  // lane whose `dirt` is not finite goes on blending while its block runs
  float dirt = row_sum(s0, 0.0f, 0.0f);
  {
    float s[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) s[r] = s0[r];
    float acc = 0.0f, ct = ct00, st = st00;
    const float* u_in = a.u0 + lane_i;
    for (int t = 0; t < T; ++t) {
      const float u0 = u_in[t * 2 * B];
      const float u1 = u_in[(t * 2 + 1) * B];
      const float rate = t >= 1 ? 1.0f : 0.0f;
      if constexpr (SETP) ex.ref(t, pr.rc, pr.re, pr.rv);
      if constexpr (BLOBS)
        acc = acc + (pr.stage_cost(s, u0, u1, rate) + ex.obs_val(s[0], s[1]));
      else
        acc = acc + pr.stage_cost(s, u0, u1, rate);
      const float se = trig.se(ct, st, s[5]);
      float sn[8];
      if constexpr (BICYCLE)
        ex.bicycle_step(pr, s, u0, u1, ct, st, se, sn);
      else
        pr.dyn_step(s, u0, u1, ct, st, se, sn);
      L.put(t, u0, u1, ct, st, se, trig.ce(ct, st, s[5]), sn);
      dirt = dirt + row_sum(sn, u0, u1);
      if constexpr (BICYCLE)
        trig.step(ct, st, s[3] * ex.invlf * u0 * dt, sn[2]);
      else
        trig.step(ct, st, u0 * dt, sn[2]);
#pragma unroll
      for (int r = 0; r < 8; ++r) s[r] = sn[r];
    }
    if constexpr (SETP) ex.ref(T, pr.rc, pr.re, pr.rv);
    if constexpr (BLOBS)
      cost = acc + (pr.term_cost(s) + ex.obs_val(s[0], s[1]));
    else
      cost = acc + pr.term_cost(s);
  }

  // ---------------- SQP loop -------------------------------------------
  float mu = mu_lo, n_small = 0.0f, done = 0.0f, conv = 0.0f;
  float gnorm = INFINITY, iters = 0.0f;
  if (a.resume != nullptr) {
    // warm restart from an earlier pass; the cost above is the rollout of
    // this call's u0, n_small and iters restart at 0
    done = a.resume[lane_i];
    conv = a.resume[B + lane_i];
    mu = a.resume[2 * B + lane_i];
    gnorm = a.resume[3 * B + lane_i];
    // a lane resumed done has run no backward here: it blends along
    if (done > 0.5f) dirt = NAN;
  }
  // The plain version (and the TPU kernel within its tile) runs the body on
  // a done lane too, with act = 0: the blend 0 * new + old changes it only
  // where the re-roll is not finite, which needs a non-finite row in its
  // trajectory or in its backward's gains. So a done lane whose `dirt` is
  // not finite runs the body with act = 0 while its block runs: under
  // TILE_EXIT in the lockstep loop, else in a second pass after the first,
  // for as many iterations as the block's longest-running lane ran after
  // it (the lanes are independent, so the order does not matter). A done
  // lane whose `dirt` is finite can still blend: its next backward runs on
  // the trajectory its last, accepted step left, which no backward has
  // read, and under the gate and mu that step set, and it may overflow
  // where the last did not. Its state does not change while its re-roll is
  // finite, so every later backward is that one, and the lane runs it once
  // (the probe): where its `chk` is finite the lane keeps its state, and
  // where it is not, its first iteration after it was done goes on through
  // the line search and the blend, and the lane is dirty from then on. The
  // probe costs nothing where a warp-mate still runs, since their
  // backward is the same code: at the per-thread exit a lane done in the
  // last iteration probes in the first pass if one does (its verdict kept
  // for the second pass, which applies it only if the block outlives the
  // lane), else in the second pass; in the lockstep loop in the first
  // iteration its block runs after it was done.
  int it_exit = 0;  // the iterations this lane ran before it was done
  bool probed = false;
  bool probe_bad = false;  // the probe's `chk` was not finite
  for (int pass = 0; pass < (TILE_EXIT ? 1 : 2); ++pass) {
    int n_it = a.max_iters;
    if (!TILE_EXIT && pass == 1) {
      __shared__ int most;
      if (threadIdx.x == 0) most = 0;
      __syncthreads();
      atomicMax(&most, it_exit);
      __syncthreads();
      n_it = most - it_exit;
    }
    for (int it = 0; it < n_it; ++it) {
      const bool dirty = !(fabsf(dirt) <= kFloatMax);
      bool probe = false;
      if (TILE_EXIT) {
        // the block decides together; every thread, done or not, gets here
        if (__syncthreads_count(done > 0.5f) >= a.n_done_needed) break;
        if (!(done < 0.5f) && !dirty) {
          if (probed) continue;
          probe = true;
        }
      } else if (pass == 0) {
        // a lane done in the last iteration probes now, beside warp-mates
        // that still run (the backward is theirs too), and exits
        const bool mates = __any_sync(__activemask(), done < 0.5f);
        if (!(done < 0.5f)) {
          if (probed || dirty || !mates) break;
          probe = true;
        } else {
          it_exit = it + 1;
        }
      } else if (!dirty) {
        if (!probed) {
          probe = true;
        } else if (probe_bad) {
          dirt = NAN;
        } else {
          break;
        }
      }
      const float act = 1.0f - done;
      // gnorm starts at +inf, so the first iteration is pure GN
      const float g_ddp = (DDP && gnorm < a.ddp_gate) ? 1.0f : 0.0f;

      // ---- backward scan with inline linearization ----
      float Vs[8], V[8][8];
      // the replay check (replay_check in solve_mega.py): a running sum of
      // every row the backward reads (s, u) or writes (k, K), finite only if
      // every row is
      float chk;
      // knots T-1 and T-2 start on their way while the terminal is read
      L.fetch_bwd(T - 1);
      copy_commit();
      if (T >= 2) L.fetch_bwd(T - 2);
      copy_commit();
      {
        float sT[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) sT[r] = L.s[(T * 8 + r) * B];
        chk = ((sT[0] + sT[1]) + (sT[2] + sT[3])) + (sT[4] + sT[5]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          Vs[i] = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) V[i][j] = 0.0f;
        }
        if constexpr (SETP) ex.ref(T, pr.rc, pr.re, pr.rv);
        Vs[3] = wv2 * (sT[3] - pr.rv);
        Vs[4] = wc2 * (sT[4] - pr.rc);
        Vs[5] = we2 * (sT[5] - pr.re);
        V[3][3] = wv2;
        V[5][5] = we2;
        if constexpr (BLOBS) {
          ex.template obs_terms<DDP>(sT[0], sT[1], g_ddp, Vs[0], Vs[1],
                                     V[0][0], V[0][1], V[1][1]);
          V[1][0] = V[0][1];
        }
      }
      float dv1 = 0.0f, dv2 = 0.0f, pg = 0.0f;
      for (int t = T - 1; t >= 0; --t) {
        // knot t-2 goes out; knots t and t-1 (for u_{t-1}) have arrived
        if (t >= 2) L.fetch_bwd(t - 2);
        copy_commit();
        copy_wait<1>();
        const float* q = L.stage(t);
        float s_t[8];
#pragma unroll
        for (int r = 0; r < 6; ++r) s_t[r] = q[r * kTile];
        // the previous control; a select at t = 0, not a multiply: 0 * NaN
        // from scratch would poison the state
        if (t >= 1) {
          const float* qp = L.stage(t - 1);
          s_t[6] = qp[6 * kTile];
          s_t[7] = qp[7 * kTile];
        } else {
          s_t[6] = 0.0f;
          s_t[7] = 0.0f;
        }
        const float ut0 = q[6 * kTile], ut1 = q[7 * kTile];
        chk = chk + ((((s_t[0] + s_t[1]) + (s_t[2] + s_t[3])) +
                      (s_t[4] + s_t[5])) +
                     (ut0 + ut1));
        const float rate = t >= 1 ? 1.0f : 0.0f;
        const float x = s_t[0], v = s_t[3], eth = s_t[5];
        const float ct = q[8 * kTile], st = q[9 * kTile];
        const float se = q[10 * kTile], ce = q[11 * kTile];
        const float fp = polyder(pr.c, pr.P, x);
        const float a02 = -v * st * dt;
        const float a03 = ct * dt;
        const float a12 = v * ct * dt;
        const float a13 = st * dt;
        const float a40 = fp;
        const float a43 = sign * se * dt;
        const float a45 = sign * v * ce * dt;
        // bicycle heading rows: A[2,3] = A[5,3] = delta dt / lf and
        // B[2,0] = B[5,0] = v dt / lf (0 and dt for the diff drive)
        float a23 = 0.0f;
        float b20 = dt;
        if constexpr (BICYCLE) {
          a23 = ut0 * ex.invlf * dt;
          b20 = v * ex.invlf * dt;
        }
        if constexpr (SETP) ex.ref(t, pr.rc, pr.re, pr.rv);
        float ogx = 0.0f, ogy = 0.0f, ohxx = 0.0f, ohxy = 0.0f, ohyy = 0.0f;
        if constexpr (BLOBS)
          ex.template obs_terms<DDP>(s_t[0], s_t[1], g_ddp, ogx, ogy, ohxx,
                                     ohxy, ohyy);

        const float wdw2 = 2.0f * rate * pr.wdang;
        const float wda2 = 2.0f * rate * pr.wdacc;
        const float du0 = ut0 - s_t[6];
        const float du1 = ut1 - s_t[7];
        const float lu0 = ww2 * ut0 + wdw2 * du0;
        const float lu1 = wa2 * ut1 + wda2 * du1;
        // Qs = l_s + A' Vs (A column 4 zero; rows 4, 6, 7 of A'Vs zero)
        float Qs[8];
        Qs[0] = Vs[0] + a40 * Vs[4];
        Qs[1] = Vs[1] - Vs[4];
        if constexpr (BLOBS) {
          Qs[0] = ogx + Qs[0];
          Qs[1] = ogy + Qs[1];
        }
        Qs[2] = a02 * Vs[0] + a12 * Vs[1] + Vs[2];
        if constexpr (BICYCLE)
          Qs[3] = wv2 * (v - pr.rv) + (a03 * Vs[0] + a13 * Vs[1] +
                                       (Vs[3] + a23 * (Vs[2] + Vs[5])) +
                                       a43 * Vs[4]);
        else
          Qs[3] = wv2 * (v - pr.rv) +
                  (a03 * Vs[0] + a13 * Vs[1] + Vs[3] + a43 * Vs[4]);
        Qs[4] = wc2 * (s_t[4] - pr.rc);
        Qs[5] = we2 * (eth - pr.re) + (a45 * Vs[4] + Vs[5]);
        Qs[6] = -wdw2 * du0;
        Qs[7] = -wda2 * du1;
        const float Qu0 = lu0 + (b20 * (Vs[2] + Vs[5]) + Vs[6]);
        const float Qu1 = lu1 + (dt * Vs[3] + Vs[7]);

        // structured VA = V @ A, column j in {0, 1, 2, 3, 5}: va[j][i]
        float va[6][8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i == 4) continue;
          va[0][i] = V[i][0];
          va[1][i] = V[i][1];
          va[2][i] = a02 * V[i][0] + a12 * V[i][1] + V[i][2];
          va[3][i] = a03 * V[i][0] + a13 * V[i][1] + V[i][3];
          if constexpr (BICYCLE)
            va[3][i] = va[3][i] + a23 * (V[i][2] + V[i][5]);
          va[5][i] = V[i][5];
        }
        // row 4's (4,2) and (4,5) entries are structurally zero, so the
        // bicycle's a23 term leaves va[3][4] as it is
        va[0][4] = a40 * wc2;
        va[1][4] = -wc2;
        va[3][4] = a43 * wc2;
        va[5][4] = a45 * wc2;

        // (A' V A)[i][j] for live i, j (column 2 of va has no row 4)
        auto atva = [&](int i, int j) -> float {
          const float* y = va[j];
          const bool h4 = j != 2;
          switch (i) {
            case 0: return h4 ? y[0] + a40 * y[4] : y[0];
            case 1: return h4 ? y[1] - y[4] : y[1];
            case 2: return a02 * y[0] + a12 * y[1] + y[2];
            case 3: {
              const float e = a03 * y[0] + a13 * y[1] + y[3];
              if constexpr (BICYCLE)
                return (h4 ? e + a43 * y[4] : e) + a23 * (y[2] + y[5]);
              else
                return h4 ? e + a43 * y[4] : e;
            }
            default: return h4 ? a45 * y[4] + y[5] : y[5];  // i == 5
          }
        };

        // exact second-order dynamics terms (gated per lane)
        float d00 = 0.0f, d22 = 0.0f, d23 = 0.0f, d35 = 0.0f, d55 = 0.0f;
        if (DDP) {
          const float fpp = polyder2(pr.c, pr.P, x);
          d00 = Vs[4] * fpp * g_ddp;
          d22 = -v * dt * (Vs[0] * ct + Vs[1] * st) * g_ddp;
          d23 = dt * (Vs[1] * ct - Vs[0] * st) * g_ddp;
          d35 = sign * dt * ce * Vs[4] * g_ddp;
          d55 = -sign * dt * v * se * Vs[4] * g_ddp;
        }

        // Qus = B' V A + l_us (column 4 zero; columns 6/7 rate coupling)
        float qus0[8], qus1[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          qus0[j] = 0.0f;
          qus1[j] = 0.0f;
          if (j == 0 || j == 1 || j == 2 || j == 3 || j == 5) {
            qus0[j] = b20 * (va[j][2] + va[j][5]) + va[j][6];
            qus1[j] = dt * va[j][3] + va[j][7];
          }
        }
        qus0[6] = -wdw2;
        qus1[7] = -wda2;
        // theta rows 2/5 under DDP: d2(v delta dt / lf) / dv d delta
        if constexpr (DDP && BICYCLE)
          qus0[3] = qus0[3] + (Vs[2] + Vs[5]) * (ex.invlf * dt) * g_ddp;

        // Quu = B' V B + l_uu, symmetrized
        float VB0[8], VB1[8];
#pragma unroll
        for (int i = 2; i < 8; ++i) {
          if (i == 4) continue;
          VB0[i] = b20 * (V[i][2] + V[i][5]) + V[i][6];
          VB1[i] = dt * V[i][3] + V[i][7];
        }
        const float btvb00 = b20 * (VB0[2] + VB0[5]) + VB0[6];
        const float btvb01 = b20 * (VB1[2] + VB1[5]) + VB1[6];
        const float btvb10 = dt * VB0[3] + VB0[7];
        const float btvb11 = dt * VB1[3] + VB1[7];
        const float offd = 0.5f * (btvb01 + btvb10);
        const float q00 = btvb00 + ww2 + wdw2;
        const float q11 = btvb11 + wa2 + wda2;

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
        for (int i = 0; i < 8; ++i) {
          Vs[i] = Qs[i] + (K0[i] * ku0 + K1[i] * ku1) +
                  (qus0[i] * k0 + qus1[i] * k1);
        }

        // Vss_n = Qss + K'Quu K + K'Qus + (K'Qus)': upper triangle, mirrored;
        // row/column 4 stays diag(wc2) and is not stored
        auto cross = [&](int i, int j) -> float {
          if (j == 6) return K0[i] * qus0[6];
          if (j == 7) return K1[i] * qus1[7];
          return K0[i] * qus0[j] + K1[i] * qus1[j];
        };
        float Vn[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i == 4) continue;
#pragma unroll
          for (int j = i; j < 8; ++j) {
            if (j == 4) continue;
            const bool li = i != 6 && i != 7;
            const bool lj = j != 6 && j != 7;
            bool has_q = false;
            float q = 0.0f;
            if (li && lj) {
              q = atva(i, j);
              has_q = true;
            }
            if (i == j) {
              if (i == 3) q = q + wv2;
              if (i == 5) q = q + we2;
              if (i == 6) { q = wdw2; has_q = true; }
              if (i == 7) { q = wda2; has_q = true; }
            }
            if constexpr (BLOBS) {
              if (i == 0 && j == 0) q = q + ohxx;
              if (i == 0 && j == 1) q = q + ohxy;
              if (i == 1 && j == 1) q = q + ohyy;
            }
            if (DDP) {
              if (i == 0 && j == 0) q = q + d00;
              if (i == 2 && j == 2) q = q + d22;
              if (i == 2 && j == 3) q = q + d23;
              if (i == 3 && j == 5) q = q + d35;
              if (i == 5 && j == 5) q = q + d55;
            }
            const float ktk0 = K0[i] * q00 + K1[i] * offd;
            const float ktk1 = K0[i] * offd + K1[i] * q11;
            const float ktk = ktk0 * K0[j] + ktk1 * K1[j];
            const float e = (has_q ? q + ktk : ktk) + cross(i, j) + cross(j, i);
            Vn[i][j] = e;
            Vn[j][i] = e;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i == 4) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j == 4) continue;
            V[i][j] = Vn[i][j];
          }
        }

        // k (2) and K without its zero column 4 (2 x 7)
        L.k[t * 2 * B] = k0;
        L.k[(t * 2 + 1) * B] = k1;
        {
          float* Kt = L.K + t * 14 * B;
          float kk = k0 + k1;
#pragma unroll
          for (int j = 0, jj = 0; j < 8; ++j) {
            if (j == 4) continue;
            Kt[jj * B] = K0[j];
            Kt[(7 + jj) * B] = K1[j];
            kk = kk + (K0[j] + K1[j]);
            ++jj;
          }
          chk = chk + kk;
        }
        dv1 = dv1 + k0 * Qu0 + k1 * Qu1;
        dv2 = dv2 + 0.5f * (k0 * quk0 + k1 * quk1);
        // pg on the weight-scale-normalized gradient
        const float pg_t =
            maxf(fabsf(ut0 - clampf(ut0 - Qu0 * inv_wscl, lb0, ub0)),
                 fabsf(ut1 - clampf(ut1 - Qu1 * inv_wscl, lb1, ub1)));
        pg = maxf(pg, pg_t);
      }

      // the probe: a finite backward leaves the done lane as it is
      if (probe) {
        probed = true;
        probe_bad = !(fabsf(chk) <= kFloatMax);
        if (!TILE_EXIT && pass == 0) break;
        if (!probe_bad) {
          if (TILE_EXIT) continue;
          break;
        }
      }

      const float pred_decrease = -(dv1 + dv2);
      // relative-cost guards tol*(s + |J|)
      const float tiny_model =
          pred_decrease <= a.tol_cost_eff * (wscl + fabsf(cost)) ? 1.0f : 0.0f;

      // ---- multi-alpha line search ----
      float S[NLS][8], accs[NLS], cts[NLS], sts[NLS];
#pragma unroll
      for (int al = 0; al < NLS; ++al) {
#pragma unroll
        for (int r = 0; r < 8; ++r) S[al][r] = s0[r];
        accs[al] = 0.0f;
        cts[al] = ct00;
        sts[al] = st00;
      }
      L.fetch_ls(0);
      copy_commit();
      if (T >= 2) L.fetch_ls(1);
      copy_commit();
      // the base trajectory's previous control (rows 6-7 of s_b)
      float up0 = 0.0f, up1 = 0.0f;
      for (int t = 0; t < T; ++t) {
        // knot t+2 goes out; knot t has arrived
        if (t + 2 < T) L.fetch_ls(t + 2);
        copy_commit();
        copy_wait<2>();
        const float* q = L.stage(t);
        float s_b[8], Km0[8], Km1[8];
#pragma unroll
        for (int r = 0; r < 6; ++r) s_b[r] = q[r * kTile];
        s_b[6] = up0;
        s_b[7] = up1;
        const float ub_0 = q[6 * kTile], ub_1 = q[7 * kTile];
        const float k0 = q[8 * kTile], k1 = q[9 * kTile];
#pragma unroll
        for (int j = 0, jj = 0; j < 8; ++j) {
          if (j == 4) {
            Km0[j] = Km1[j] = 0.0f;
            continue;
          }
          Km0[j] = q[(10 + jj) * kTile];
          Km1[j] = q[(17 + jj) * kTile];
          ++jj;
        }
        up0 = ub_0;
        up1 = ub_1;
        const float rate = t >= 1 ? 1.0f : 0.0f;
        if constexpr (SETP) ex.ref(t, pr.rc, pr.re, pr.rv);
#pragma unroll
        for (int al = 0; al < NLS; ++al) {
          const float alpha = 1.0f / (float)(1 << al);
          float ds[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) ds[j] = S[al][j] - s_b[j];
          const float u0 = clampf(feedback(ub_0, alpha, k0, Km0, ds), lb0, ub0);
          const float u1 = clampf(feedback(ub_1, alpha, k1, Km1, ds), lb1, ub1);
          // the candidate's controls, for the winner's re-roll
          L.cu[(al * T + t) * 2 * B] = u0;
          L.cu[((al * T + t) * 2 + 1) * B] = u1;
          if constexpr (BLOBS)
            accs[al] = accs[al] + (pr.stage_cost(S[al], u0, u1, rate) +
                                   ex.obs_val(S[al][0], S[al][1]));
          else
            accs[al] = accs[al] + pr.stage_cost(S[al], u0, u1, rate);
          const float se = trig.se(cts[al], sts[al], S[al][5]);
          float sn[8];
          if constexpr (BICYCLE) {
            ex.bicycle_step(pr, S[al], u0, u1, cts[al], sts[al], se, sn);
            trig.step(cts[al], sts[al], S[al][3] * ex.invlf * u0 * dt, sn[2]);
          } else {
            pr.dyn_step(S[al], u0, u1, cts[al], sts[al], se, sn);
            trig.step(cts[al], sts[al], u0 * dt, sn[2]);
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) S[al][r] = sn[r];
        }
      }
      // the first (largest) alpha that lowers the cost wins
      float picked = 0.0f, alpha_sel = 0.0f, cost_sel = cost;
      int win = 0;
      if constexpr (SETP) ex.ref(T, pr.rc, pr.re, pr.rv);
#pragma unroll
      for (int al = 0; al < NLS; ++al) {
        float cost_a;
        if constexpr (BLOBS)
          cost_a = accs[al] + (pr.term_cost(S[al]) +
                               ex.obs_val(S[al][0], S[al][1]));
        else
          cost_a = accs[al] + pr.term_cost(S[al]);
        if (a.diag != nullptr && act > 0.5f) a.diag[al * B + lane_i] = cost_a;
        const float improved = cost_a < cost ? 1.0f : 0.0f;
        const float take = improved * (1.0f - minf(picked, 1.0f));
        picked = picked + take;
        alpha_sel = alpha_sel + take * (1.0f / (float)(1 << al));
        cost_sel = take > 0.5f ? cost_a : cost_sel;
        win = take > 0.5f ? al : win;
      }
      if (a.diag != nullptr && act > 0.5f) {
        a.diag[NLS * B + lane_i] = cost;
        a.diag[(NLS + 1) * B + lane_i] = alpha_sel;
      }
      const float accepted = minf(picked, 1.0f);
      const float upd = accepted * act;

      // ---- the winner's re-roll. Where every row the backward read or wrote
      // is finite: on an accepted step the recorded controls replayed from
      // s0, written in place; a rejected step keeps its trajectory and skips
      // this. On any other lane the TPU kernel's re-roll, recomputed and
      // blended (see reroll_blend) ----
      const bool exact = fabsf(chk) <= kFloatMax;
      // the sum of the trajectory the re-roll leaves (0: the one the
      // backward read, whose rows chk found finite)
      float trail = 0.0f;
      if (!exact) {
        trail = reroll_blend<BICYCLE>(L, pr, ex, trig, s0, ct00, st00,
                                      alpha_sel, upd, lb0, lb1, ub0, ub1);
      } else if (upd > 0.5f) {
        trail = row_sum(s0, 0.0f, 0.0f);
        const float* cw = L.cu + win * T * 2 * B;
        float sa[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) sa[r] = s0[r];
        float ct = ct00, st = st00;
        float u0 = cw[0], u1 = cw[B];
        for (int t = 0; t < T; ++t) {
          // the next knot's controls load while this knot computes
          const int tn = t + 1 < T ? t + 1 : t;
          const float u0n = cw[tn * 2 * B], u1n = cw[(tn * 2 + 1) * B];
          const float se = trig.se(ct, st, sa[5]);
          float sn[8];
          if constexpr (BICYCLE)
            ex.bicycle_step(pr, sa, u0, u1, ct, st, se, sn);
          else
            pr.dyn_step(sa, u0, u1, ct, st, se, sn);
          L.put(t, u0, u1, ct, st, se, trig.ce(ct, st, sa[5]), sn);
          trail = trail + row_sum(sn, u0, u1);
          if constexpr (BICYCLE)
            trig.step(ct, st, sa[3] * ex.invlf * u0 * dt, sn[2]);
          else
            trig.step(ct, st, u0 * dt, sn[2]);
#pragma unroll
          for (int r = 0; r < 8; ++r) sa[r] = sn[r];
          u0 = u0n;
          u1 = u1n;
        }
      }
      dirt = chk + trail;
      const float cost2 = upd > 0.5f ? cost_sel : cost;

      // ---- per-lane bookkeeping ----
      const bool on = act > 0.5f;
      const float mu2 = upd > 0.5f ? maxf(mu / a.mu_factor, mu_lo)
                        : on       ? minf(mu * a.mu_factor, mu_hi)
                                   : mu;
      const float small_step =
          accepted *
          (fabsf(cost - cost2) <= a.tol_cost_eff * (wscl + fabsf(cost)) ? 1.0f
                                                                        : 0.0f);
      const float n_small2 =
          on ? (small_step > 0.5f ? n_small + 1.0f : 0.0f) : n_small;
      // a tiny predicted decrease certifies only with the trust region open;
      // under inflated mu it is a stall only if the step was also rejected
      const float mu_open = mu <= mu_lo * a.mu_factor ? 1.0f : 0.0f;
      const float converged_now =
          maxf(maxf(pg < a.tol_grad ? 1.0f : 0.0f, n_small2 >= 2.0f ? 1.0f : 0.0f),
               tiny_model * mu_open);
      const float stalled =
          maxf((1.0f - accepted) * (mu2 >= mu_hi ? 1.0f : 0.0f),
               tiny_model * (1.0f - mu_open) * (1.0f - accepted));
      done = on ? maxf(converged_now, stalled) : done;
      conv = on ? converged_now : conv;
      gnorm = on ? pg : gnorm;
      iters = iters + act;
      cost = cost2;
      mu = mu2;
      n_small = n_small2;
    }
  }

  // ---------------- outputs --------------------------------------------
  // the trajectory is already in ss rows 0-5 and us; rows 6-7 of ss carry
  // knot t's previous control (zero at t = 0)
  L.s[6 * B] = 0.0f;
  L.s[7 * B] = 0.0f;
  for (int t = 1; t <= T; ++t) {
    L.s[(t * 8 + 6) * B] = L.u[(t - 1) * 2 * B];
    L.s[(t * 8 + 7) * B] = L.u[((t - 1) * 2 + 1) * B];
  }
  a.cost[lane_i] = cost;
  a.conv[lane_i] = conv;
  a.iters[lane_i] = iters;
  a.gnorm[lane_i] = gnorm;
  a.mu[lane_i] = mu;
  a.done[lane_i] = done;
}

// One lane's solve on the persistent grid (grid_loop): its constants and
// SQP loop state, and the one-lane-per-thread kernel's SQP iteration split
// into the phases that the grid's warps run together, the same operations
// in the same order. The caller points L at the slot's working set and ex
// at its setpoints and blobs (by_slot), then loads a lane.
template <int NLS, bool DDP, bool FAST, bool ADAPT, bool BLOBS, bool SETP,
          bool BICYCLE>
struct Solve {
  Lane L;
  Problem pr;
  Extras ex;
  Trig<FAST, BICYCLE> trig;
  float lb0, lb1, ub0, ub1;
  // one-sided weight-scale equivariance: s = max(1, sum(w)/470) scales the
  // mu floor/ceiling and the relative-cost guards; pg is measured as 1/s
  float wscl, inv_wscl, mu_lo, mu_hi;
  float s0[8];
  float ct00, st00;
  float cost, mu, n_small, done, conv, gnorm, iters;
  // `dirt`: finite only if the lane's trajectory (rows 0-5 of s and the
  // controls) and the rows its last backward read and wrote are; a done
  // lane whose `dirt` is not finite goes on blending while its tile runs
  float dirt;
  // the last backward's replay check (see below), predicted decrease terms
  // and projected gradient
  float chk, dv1, dv2, pg;
  // the last line search's outcome
  float tiny_model, accepted, alpha_sel, cost_sel;
  int win;

  // Reads lane `lane` of the inputs (batch stride a.B): its constants, and
  // its loop state started or resumed. The initial rollout comes next.
  __device__ __forceinline__ void load(const Args& a, int lane) {
    const int B = a.B;
    float par[N_PAR];
#pragma unroll
    for (int r = 0; r < N_PAR; ++r) par[r] = a.par[r * B + lane];
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
    if constexpr (BICYCLE) ex.invlf = 1.0f / par[P_LF];
    lb0 = a.lb[lane];
    lb1 = a.lb[B + lane];
    ub0 = a.ub[lane];
    ub1 = a.ub[B + lane];
    if (ADAPT) {
      wscl = maxf((pr.wcte + pr.weth + pr.wvel + pr.wang + pr.wacc +
                   pr.wdang + pr.wdacc) * (float)(1.0 / 470.0),
                  1.0f);
      inv_wscl = 1.0f / wscl;
      mu_lo = a.mu_min * wscl;
      mu_hi = a.mu_max * wscl;
    } else {
      wscl = 1.0f;
      inv_wscl = 1.0f;
      mu_lo = a.mu_min;
      mu_hi = a.mu_max;
    }

#pragma unroll
    for (int r = 0; r < 6; ++r) s0[r] = a.z0[r * B + lane];
    s0[6] = 0.0f;
    s0[7] = 0.0f;
    ct00 = cosf(s0[2]);
    st00 = sinf(s0[2]);
    trig = Trig<FAST, BICYCLE>{1.0f, 0.0f};
    if (FAST) {
      const float phi = s0[5] - s0[2];
      trig.cphi = cosf(phi);
      trig.sphi = sinf(phi);
    }

    mu = mu_lo;
    n_small = 0.0f;
    done = 0.0f;
    conv = 0.0f;
    gnorm = INFINITY;
    iters = 0.0f;
    if (a.resume != nullptr) {
      // warm restart from an earlier pass; the cost is the initial rollout
      // of this call's u0, n_small and iters restart at 0
      done = a.resume[lane];
      conv = a.resume[B + lane];
      mu = a.resume[2 * B + lane];
      gnorm = a.resume[3 * B + lane];
    }
  }

  // A rollout from s0 under the controls src[t * 2 * cs] and
  // src[(t * 2 + 1) * cs], in place: knot 0's state, then per knot the
  // control, the trig cache and the next state. Returns the sum of the
  // rows it leaves, finite only if each is. With `first` it is the initial
  // rollout and also sets the cost; without, the winner's re-roll, which
  // replays the controls the line search recorded. The controls load kChunk
  // knots at a time, ahead of the steps that use them.
  __device__ __forceinline__ float rollout(const float* src, int cs,
                                           bool first) {
    const int T = L.T;
    const float dt = pr.dt;
#pragma unroll
    for (int r = 0; r < 6; ++r) L.s[r * L.B] = s0[r];
    float sum = row_sum(s0, 0.0f, 0.0f);
    float s[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) s[r] = s0[r];
    float acc = 0.0f, ct = ct00, st = st00;
    for (int t0 = 0; t0 < T; t0 += kChunk) {
      float uc[kChunk][2];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int t = t0 + j < T ? t0 + j : T - 1;
        uc[j][0] = src[t * 2 * cs];
        uc[j][1] = src[(t * 2 + 1) * cs];
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int t = t0 + j;
        if (t >= T) break;
        const float u0 = uc[j][0];
        const float u1 = uc[j][1];
        if (first) {
          const float rate = t >= 1 ? 1.0f : 0.0f;
          if constexpr (SETP) ex.ref(t, pr.rc, pr.re, pr.rv);
          if constexpr (BLOBS)
            acc = acc +
                  (pr.stage_cost(s, u0, u1, rate) + ex.obs_val(s[0], s[1]));
          else
            acc = acc + pr.stage_cost(s, u0, u1, rate);
        }
        const float se = trig.se(ct, st, s[5]);
        float sn[8];
        if constexpr (BICYCLE)
          ex.bicycle_step(pr, s, u0, u1, ct, st, se, sn);
        else
          pr.dyn_step(s, u0, u1, ct, st, se, sn);
        L.put(t, u0, u1, ct, st, se, trig.ce(ct, st, s[5]), sn);
        sum = sum + row_sum(sn, u0, u1);
        if constexpr (BICYCLE)
          trig.step(ct, st, s[3] * ex.invlf * u0 * dt, sn[2]);
        else
          trig.step(ct, st, u0 * dt, sn[2]);
#pragma unroll
        for (int r = 0; r < 8; ++r) s[r] = sn[r];
      }
    }
    if (first) {
      if constexpr (SETP) ex.ref(T, pr.rc, pr.re, pr.rv);
      if constexpr (BLOBS)
        cost = acc + (pr.term_cost(s) + ex.obs_val(s[0], s[1]));
      else
        cost = acc + pr.term_cost(s);
    }
    return sum;
  }

  // After the initial rollout (the sum of its rows): a lane resumed done has
  // run no backward here, so it blends along.
  __device__ __forceinline__ void start(float sum) {
    dirt = done > 0.5f ? NAN : sum;
  }

  // The backward scan with inline linearization: writes the gains k, K and
  // sets chk, dv1, dv2 and pg. With `xs` (the lane's (T+1, 8) rows of a
  // lane-major ss) it also writes the trajectory it reads there, knot t's
  // state and the control before it, a whole 32-byte row of the lane at a
  // time: the persistent grid's exit, whose probe reads every knot anyway.
  __device__ __forceinline__ void backward(const Args& a,
                                           float* xs = nullptr) {
    const int B = L.B;
    const int T = L.T;
    const float dt = pr.dt;
    const float sign = pr.sign;
    const float wv2 = 2.0f * pr.wvel;
    const float wc2 = 2.0f * pr.wcte;
    const float we2 = 2.0f * pr.weth;
    const float ww2 = 2.0f * pr.wang;
    const float wa2 = 2.0f * pr.wacc;
    // gnorm starts at +inf, so the first iteration is pure GN
    const float g_ddp = (DDP && gnorm < a.ddp_gate) ? 1.0f : 0.0f;
    float Vs[8], V[8][8];
    // the replay check (replay_check in solve_mega.py): a running sum of
    // every row the backward reads (s, u) or writes (k, K), finite only if
    // every row is
    // knots T-1 and T-2 start on their way while the terminal is read
    L.fetch_bwd(T - 1);
    copy_commit();
    if (T >= 2) L.fetch_bwd(T - 2);
    copy_commit();
    {
      float sT[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) sT[r] = L.s[(T * 8 + r) * B];
      chk = ((sT[0] + sT[1]) + (sT[2] + sT[3])) + (sT[4] + sT[5]);
      if (xs != nullptr) {
        float4* o = reinterpret_cast<float4*>(xs + T * 8);
        o[0] = make_float4(sT[0], sT[1], sT[2], sT[3]);
        o[1] = make_float4(sT[4], sT[5], L.u[(T - 1) * 2 * B],
                           L.u[((T - 1) * 2 + 1) * B]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        Vs[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) V[i][j] = 0.0f;
      }
      if constexpr (SETP) ex.ref(T, pr.rc, pr.re, pr.rv);
      Vs[3] = wv2 * (sT[3] - pr.rv);
      Vs[4] = wc2 * (sT[4] - pr.rc);
      Vs[5] = we2 * (sT[5] - pr.re);
      V[3][3] = wv2;
      V[5][5] = we2;
      if constexpr (BLOBS) {
        ex.template obs_terms<DDP>(sT[0], sT[1], g_ddp, Vs[0], Vs[1],
                                   V[0][0], V[0][1], V[1][1]);
        V[1][0] = V[0][1];
      }
    }
    dv1 = 0.0f;
    dv2 = 0.0f;
    pg = 0.0f;
    for (int t = T - 1; t >= 0; --t) {
      // knot t-2 goes out; knots t and t-1 (for u_{t-1}) have arrived
      if (t >= 2) L.fetch_bwd(t - 2);
      copy_commit();
      copy_wait<1>();
      const float* q = L.stage(t);
      float s_t[8];
#pragma unroll
      for (int r = 0; r < 6; ++r) s_t[r] = q[r * kTile];
      // the previous control; a select at t = 0, not a multiply: 0 * NaN
      // from scratch would poison the state
      if (t >= 1) {
        const float* qp = L.stage(t - 1);
        s_t[6] = qp[6 * kTile];
        s_t[7] = qp[7 * kTile];
      } else {
        s_t[6] = 0.0f;
        s_t[7] = 0.0f;
      }
      const float ut0 = q[6 * kTile], ut1 = q[7 * kTile];
      if (xs != nullptr) {
        float4* o = reinterpret_cast<float4*>(xs + t * 8);
        o[0] = make_float4(s_t[0], s_t[1], s_t[2], s_t[3]);
        o[1] = make_float4(s_t[4], s_t[5], s_t[6], s_t[7]);
      }
      chk = chk + ((((s_t[0] + s_t[1]) + (s_t[2] + s_t[3])) +
                    (s_t[4] + s_t[5])) +
                   (ut0 + ut1));
      const float rate = t >= 1 ? 1.0f : 0.0f;
      const float x = s_t[0], v = s_t[3], eth = s_t[5];
      const float ct = q[8 * kTile], st = q[9 * kTile];
      const float se = q[10 * kTile], ce = q[11 * kTile];
      const float fp = polyder(pr.c, pr.P, x);
      const float a02 = -v * st * dt;
      const float a03 = ct * dt;
      const float a12 = v * ct * dt;
      const float a13 = st * dt;
      const float a40 = fp;
      const float a43 = sign * se * dt;
      const float a45 = sign * v * ce * dt;
      // bicycle heading rows: A[2,3] = A[5,3] = delta dt / lf and
      // B[2,0] = B[5,0] = v dt / lf (0 and dt for the diff drive)
      float a23 = 0.0f;
      float b20 = dt;
      if constexpr (BICYCLE) {
        a23 = ut0 * ex.invlf * dt;
        b20 = v * ex.invlf * dt;
      }
      if constexpr (SETP) ex.ref(t, pr.rc, pr.re, pr.rv);
      float ogx = 0.0f, ogy = 0.0f, ohxx = 0.0f, ohxy = 0.0f, ohyy = 0.0f;
      if constexpr (BLOBS)
        ex.template obs_terms<DDP>(s_t[0], s_t[1], g_ddp, ogx, ogy, ohxx,
                                   ohxy, ohyy);

      const float wdw2 = 2.0f * rate * pr.wdang;
      const float wda2 = 2.0f * rate * pr.wdacc;
      const float du0 = ut0 - s_t[6];
      const float du1 = ut1 - s_t[7];
      const float lu0 = ww2 * ut0 + wdw2 * du0;
      const float lu1 = wa2 * ut1 + wda2 * du1;
      // Qs = l_s + A' Vs (A column 4 zero; rows 4, 6, 7 of A'Vs zero)
      float Qs[8];
      Qs[0] = Vs[0] + a40 * Vs[4];
      Qs[1] = Vs[1] - Vs[4];
      if constexpr (BLOBS) {
        Qs[0] = ogx + Qs[0];
        Qs[1] = ogy + Qs[1];
      }
      Qs[2] = a02 * Vs[0] + a12 * Vs[1] + Vs[2];
      if constexpr (BICYCLE)
        Qs[3] = wv2 * (v - pr.rv) + (a03 * Vs[0] + a13 * Vs[1] +
                                     (Vs[3] + a23 * (Vs[2] + Vs[5])) +
                                     a43 * Vs[4]);
      else
        Qs[3] = wv2 * (v - pr.rv) +
                (a03 * Vs[0] + a13 * Vs[1] + Vs[3] + a43 * Vs[4]);
      Qs[4] = wc2 * (s_t[4] - pr.rc);
      Qs[5] = we2 * (eth - pr.re) + (a45 * Vs[4] + Vs[5]);
      Qs[6] = -wdw2 * du0;
      Qs[7] = -wda2 * du1;
      const float Qu0 = lu0 + (b20 * (Vs[2] + Vs[5]) + Vs[6]);
      const float Qu1 = lu1 + (dt * Vs[3] + Vs[7]);

      // structured VA = V @ A, column j in {0, 1, 2, 3, 5}: va[j][i]
      float va[6][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i == 4) continue;
        va[0][i] = V[i][0];
        va[1][i] = V[i][1];
        va[2][i] = a02 * V[i][0] + a12 * V[i][1] + V[i][2];
        va[3][i] = a03 * V[i][0] + a13 * V[i][1] + V[i][3];
        if constexpr (BICYCLE)
          va[3][i] = va[3][i] + a23 * (V[i][2] + V[i][5]);
        va[5][i] = V[i][5];
      }
      // row 4's (4,2) and (4,5) entries are structurally zero, so the
      // bicycle's a23 term leaves va[3][4] as it is
      va[0][4] = a40 * wc2;
      va[1][4] = -wc2;
      va[3][4] = a43 * wc2;
      va[5][4] = a45 * wc2;

      // (A' V A)[i][j] for live i, j (column 2 of va has no row 4)
      auto atva = [&](int i, int j) -> float {
        const float* y = va[j];
        const bool h4 = j != 2;
        switch (i) {
          case 0: return h4 ? y[0] + a40 * y[4] : y[0];
          case 1: return h4 ? y[1] - y[4] : y[1];
          case 2: return a02 * y[0] + a12 * y[1] + y[2];
          case 3: {
            const float e = a03 * y[0] + a13 * y[1] + y[3];
            if constexpr (BICYCLE)
              return (h4 ? e + a43 * y[4] : e) + a23 * (y[2] + y[5]);
            else
              return h4 ? e + a43 * y[4] : e;
          }
          default: return h4 ? a45 * y[4] + y[5] : y[5];  // i == 5
        }
      };

      // exact second-order dynamics terms (gated per lane)
      float d00 = 0.0f, d22 = 0.0f, d23 = 0.0f, d35 = 0.0f, d55 = 0.0f;
      if (DDP) {
        const float fpp = polyder2(pr.c, pr.P, x);
        d00 = Vs[4] * fpp * g_ddp;
        d22 = -v * dt * (Vs[0] * ct + Vs[1] * st) * g_ddp;
        d23 = dt * (Vs[1] * ct - Vs[0] * st) * g_ddp;
        d35 = sign * dt * ce * Vs[4] * g_ddp;
        d55 = -sign * dt * v * se * Vs[4] * g_ddp;
      }

      // Qus = B' V A + l_us (column 4 zero; columns 6/7 rate coupling)
      float qus0[8], qus1[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qus0[j] = 0.0f;
        qus1[j] = 0.0f;
        if (j == 0 || j == 1 || j == 2 || j == 3 || j == 5) {
          qus0[j] = b20 * (va[j][2] + va[j][5]) + va[j][6];
          qus1[j] = dt * va[j][3] + va[j][7];
        }
      }
      qus0[6] = -wdw2;
      qus1[7] = -wda2;
      // theta rows 2/5 under DDP: d2(v delta dt / lf) / dv d delta
      if constexpr (DDP && BICYCLE)
        qus0[3] = qus0[3] + (Vs[2] + Vs[5]) * (ex.invlf * dt) * g_ddp;

      // Quu = B' V B + l_uu, symmetrized
      float VB0[8], VB1[8];
#pragma unroll
      for (int i = 2; i < 8; ++i) {
        if (i == 4) continue;
        VB0[i] = b20 * (V[i][2] + V[i][5]) + V[i][6];
        VB1[i] = dt * V[i][3] + V[i][7];
      }
      const float btvb00 = b20 * (VB0[2] + VB0[5]) + VB0[6];
      const float btvb01 = b20 * (VB1[2] + VB1[5]) + VB1[6];
      const float btvb10 = dt * VB0[3] + VB0[7];
      const float btvb11 = dt * VB1[3] + VB1[7];
      const float offd = 0.5f * (btvb01 + btvb10);
      const float q00 = btvb00 + ww2 + wdw2;
      const float q11 = btvb11 + wa2 + wda2;

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
      for (int i = 0; i < 8; ++i) {
        Vs[i] = Qs[i] + (K0[i] * ku0 + K1[i] * ku1) +
                (qus0[i] * k0 + qus1[i] * k1);
      }

      // Vss_n = Qss + K'Quu K + K'Qus + (K'Qus)': upper triangle,
      // mirrored; row/column 4 stays diag(wc2) and is not stored
      auto cross = [&](int i, int j) -> float {
        if (j == 6) return K0[i] * qus0[6];
        if (j == 7) return K1[i] * qus1[7];
        return K0[i] * qus0[j] + K1[i] * qus1[j];
      };
      float Vn[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i == 4) continue;
#pragma unroll
        for (int j = i; j < 8; ++j) {
          if (j == 4) continue;
          const bool li = i != 6 && i != 7;
          const bool lj = j != 6 && j != 7;
          bool has_q = false;
          float q = 0.0f;
          if (li && lj) {
            q = atva(i, j);
            has_q = true;
          }
          if (i == j) {
            if (i == 3) q = q + wv2;
            if (i == 5) q = q + we2;
            if (i == 6) { q = wdw2; has_q = true; }
            if (i == 7) { q = wda2; has_q = true; }
          }
          if constexpr (BLOBS) {
            if (i == 0 && j == 0) q = q + ohxx;
            if (i == 0 && j == 1) q = q + ohxy;
            if (i == 1 && j == 1) q = q + ohyy;
          }
          if (DDP) {
            if (i == 0 && j == 0) q = q + d00;
            if (i == 2 && j == 2) q = q + d22;
            if (i == 2 && j == 3) q = q + d23;
            if (i == 3 && j == 5) q = q + d35;
            if (i == 5 && j == 5) q = q + d55;
          }
          const float ktk0 = K0[i] * q00 + K1[i] * offd;
          const float ktk1 = K0[i] * offd + K1[i] * q11;
          const float ktk = ktk0 * K0[j] + ktk1 * K1[j];
          const float e =
              (has_q ? q + ktk : ktk) + cross(i, j) + cross(j, i);
          Vn[i][j] = e;
          Vn[j][i] = e;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i == 4) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j == 4) continue;
          V[i][j] = Vn[i][j];
        }
      }

      // k (2) and K without its zero column 4 (2 x 7)
      L.k[t * 2 * B] = k0;
      L.k[(t * 2 + 1) * B] = k1;
      {
        float* Kt = L.K + t * 14 * B;
        float kk = k0 + k1;
#pragma unroll
        for (int j = 0, jj = 0; j < 8; ++j) {
          if (j == 4) continue;
          Kt[jj * B] = K0[j];
          Kt[(7 + jj) * B] = K1[j];
          kk = kk + (K0[j] + K1[j]);
          ++jj;
        }
        chk = chk + kk;
      }
      dv1 = dv1 + k0 * Qu0 + k1 * Qu1;
      dv2 = dv2 + 0.5f * (k0 * quk0 + k1 * quk1);
      // pg on the weight-scale-normalized gradient
      const float pg_t =
          maxf(fabsf(ut0 - clampf(ut0 - Qu0 * inv_wscl, lb0, ub0)),
               fabsf(ut1 - clampf(ut1 - Qu1 * inv_wscl, lb1, ub1)));
      pg = maxf(pg, pg_t);
    }
  }

  // The line search of an SQP iteration after its backward: sets the
  // step's outcome (tiny_model, accepted, alpha_sel, cost_sel, win). A done
  // lane (act = 0) searches too, only to blend; `lane` addresses the
  // optional diag output.
  __device__ __forceinline__ void search(const Args& a, int lane) {
    const int B = L.B;
    const int T = L.T;
    const float dt = pr.dt;
    const float act = 1.0f - done;
    const float pred_decrease = -(dv1 + dv2);
    // relative-cost guards tol*(s + |J|)
    tiny_model =
        pred_decrease <= a.tol_cost_eff * (wscl + fabsf(cost)) ? 1.0f : 0.0f;

    // ---- multi-alpha line search ----
    float S[NLS][8], accs[NLS], cts[NLS], sts[NLS];
#pragma unroll
    for (int al = 0; al < NLS; ++al) {
#pragma unroll
      for (int r = 0; r < 8; ++r) S[al][r] = s0[r];
      accs[al] = 0.0f;
      cts[al] = ct00;
      sts[al] = st00;
    }
    L.fetch_ls(0);
    copy_commit();
    if (T >= 2) L.fetch_ls(1);
    copy_commit();
    // the base trajectory's previous control (rows 6-7 of s_b)
    float up0 = 0.0f, up1 = 0.0f;
    for (int t = 0; t < T; ++t) {
      // knot t+2 goes out; knot t has arrived
      if (t + 2 < T) L.fetch_ls(t + 2);
      copy_commit();
      copy_wait<2>();
      const float* q = L.stage(t);
      float s_b[8], Km0[8], Km1[8];
#pragma unroll
      for (int r = 0; r < 6; ++r) s_b[r] = q[r * kTile];
      s_b[6] = up0;
      s_b[7] = up1;
      const float ub_0 = q[6 * kTile], ub_1 = q[7 * kTile];
      const float k0 = q[8 * kTile], k1 = q[9 * kTile];
#pragma unroll
      for (int j = 0, jj = 0; j < 8; ++j) {
        if (j == 4) {
          Km0[j] = Km1[j] = 0.0f;
          continue;
        }
        Km0[j] = q[(10 + jj) * kTile];
        Km1[j] = q[(17 + jj) * kTile];
        ++jj;
      }
      up0 = ub_0;
      up1 = ub_1;
      const float rate = t >= 1 ? 1.0f : 0.0f;
      if constexpr (SETP) ex.ref(t, pr.rc, pr.re, pr.rv);
#pragma unroll
      for (int al = 0; al < NLS; ++al) {
        const float alpha = 1.0f / (float)(1 << al);
        float ds[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) ds[j] = S[al][j] - s_b[j];
        const float u0 = clampf(feedback(ub_0, alpha, k0, Km0, ds), lb0, ub0);
        const float u1 = clampf(feedback(ub_1, alpha, k1, Km1, ds), lb1, ub1);
        // the candidate's controls, for the winner's re-roll
        L.cu[(al * T + t) * 2 * B] = u0;
        L.cu[((al * T + t) * 2 + 1) * B] = u1;
        if constexpr (BLOBS)
          accs[al] = accs[al] + (pr.stage_cost(S[al], u0, u1, rate) +
                                 ex.obs_val(S[al][0], S[al][1]));
        else
          accs[al] = accs[al] + pr.stage_cost(S[al], u0, u1, rate);
        const float se = trig.se(cts[al], sts[al], S[al][5]);
        float sn[8];
        if constexpr (BICYCLE) {
          ex.bicycle_step(pr, S[al], u0, u1, cts[al], sts[al], se, sn);
          trig.step(cts[al], sts[al], S[al][3] * ex.invlf * u0 * dt, sn[2]);
        } else {
          pr.dyn_step(S[al], u0, u1, cts[al], sts[al], se, sn);
          trig.step(cts[al], sts[al], u0 * dt, sn[2]);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) S[al][r] = sn[r];
      }
    }
    // the first (largest) alpha that lowers the cost wins
    float picked = 0.0f;
    alpha_sel = 0.0f;
    cost_sel = cost;
    win = 0;
    if constexpr (SETP) ex.ref(T, pr.rc, pr.re, pr.rv);
#pragma unroll
    for (int al = 0; al < NLS; ++al) {
      float cost_a;
      if constexpr (BLOBS)
        cost_a = accs[al] + (pr.term_cost(S[al]) +
                             ex.obs_val(S[al][0], S[al][1]));
      else
        cost_a = accs[al] + pr.term_cost(S[al]);
      if (a.diag != nullptr && act > 0.5f) a.diag[al * a.B + lane] = cost_a;
      const float improved = cost_a < cost ? 1.0f : 0.0f;
      const float take = improved * (1.0f - minf(picked, 1.0f));
      picked = picked + take;
      alpha_sel = alpha_sel + take * (1.0f / (float)(1 << al));
      cost_sel = take > 0.5f ? cost_a : cost_sel;
      win = take > 0.5f ? al : win;
    }
    if (a.diag != nullptr && act > 0.5f) {
      a.diag[NLS * a.B + lane] = cost;
      a.diag[(NLS + 1) * a.B + lane] = alpha_sel;
    }
    accepted = minf(picked, 1.0f);
  }

  // Whether the re-roll replays the recorded controls (see reroll).
  __device__ __forceinline__ bool replays() const {
    return fabsf(chk) <= kFloatMax && accepted * (1.0f - done) > 0.5f;
  }

  // The TPU kernel's re-roll, recomputed and blended (see reroll_blend).
  __device__ __forceinline__ float blend() const {
    return reroll_blend<BICYCLE>(L, pr, ex, trig, s0, ct00, st00, alpha_sel,
                                 accepted * (1.0f - done), lb0, lb1, ub0,
                                 ub1);
  }

  // The end of an SQP iteration, given the re-roll's sum: the lane's
  // bookkeeping.
  __device__ __forceinline__ void settle(const Args& a, float trail) {
    const float act = 1.0f - done;
    const float upd = accepted * act;
    dirt = chk + trail;
    const float cost2 = upd > 0.5f ? cost_sel : cost;

    // ---- per-lane bookkeeping ----
    const bool on = act > 0.5f;
    const float mu2 = upd > 0.5f ? maxf(mu / a.mu_factor, mu_lo)
                      : on       ? minf(mu * a.mu_factor, mu_hi)
                                 : mu;
    const float small_step =
        accepted *
        (fabsf(cost - cost2) <= a.tol_cost_eff * (wscl + fabsf(cost)) ? 1.0f
                                                                      : 0.0f);
    const float n_small2 =
        on ? (small_step > 0.5f ? n_small + 1.0f : 0.0f) : n_small;
    // a tiny predicted decrease certifies only with the trust region open;
    // under inflated mu it is a stall only if the step was also rejected
    const float mu_open = mu <= mu_lo * a.mu_factor ? 1.0f : 0.0f;
    const float converged_now =
        maxf(maxf(pg < a.tol_grad ? 1.0f : 0.0f, n_small2 >= 2.0f ? 1.0f : 0.0f),
             tiny_model * mu_open);
    const float stalled =
        maxf((1.0f - accepted) * (mu2 >= mu_hi ? 1.0f : 0.0f),
             tiny_model * (1.0f - mu_open) * (1.0f - accepted));
    done = on ? maxf(converged_now, stalled) : done;
    conv = on ? converged_now : conv;
    gnorm = on ? pg : gnorm;
    iters = iters + act;
    cost = cost2;
    mu = mu2;
    n_small = n_small2;
  }

  // The six per-lane outputs, the columns of one lane-major (B, 6) array.
  __device__ __forceinline__ void put_scalars(const Args& a, int lane) const {
    const int i = lane * 6;
    a.cost[i] = cost;
    a.conv[i] = conv;
    a.iters[i] = iters;
    a.gnorm[i] = gnorm;
    a.mu[i] = mu;
    a.done[i] = done;
  }
};

// The slot-indexed working set (stride S = a.slots) of the persistent
// grid: rows 0-5 of the trajectory's (T+1, 8, S) states and its (T, 2, S)
// controls, then the setpoint profile (T+1, 3, S) and the blobs (4,
// n_blobs, S) of the variants that read them at every knot.
template <class SolveT>
__device__ __forceinline__ void by_slot(SolveT& sv, const Args& a,
                                        int slot) {
  const int S = a.slots, T = a.T;
  float* w = a.work + slot;
  float* u = w + (T + 1) * 8 * S;
  float* x = u + T * 2 * S;
  float* xb = a.setp != nullptr ? x + (T + 1) * 3 * S : x;
  const int nb = a.n_blobs * S;
  sv.L = Lane{w, u, a.traj_g + slot, a.ks + slot, a.Ks + slot,
              a.cand_u + slot, ring_base() + threadIdx.x, S, T};
  sv.ex = Extras{x, xb, xb + nb, xb + 2 * nb, xb + 3 * nb, a.n_blobs, S,
                 0.0f};
}

// A lane's setpoints and blobs, copied once into the slot's working set
// (one scattered read each instead of one at every knot and candidate).
template <bool BLOBS, bool SETP>
__device__ __forceinline__ void stage_extras(const Extras& ex, const Args& a,
                                             int lane) {
  const int B = a.B, S = ex.B;
  if constexpr (SETP) {
    float* d = const_cast<float*>(ex.setp);
    for (int i = 0; i < (a.T + 1) * 3; ++i) d[i * S] = a.setp[i * B + lane];
  }
  if constexpr (BLOBS) {
    float* d = const_cast<float*>(ex.bx);
    const int nb = a.n_blobs;
    for (int k = 0; k < nb; ++k) {
      d[k * S] = a.bx[k * B + lane];
      d[(nb + k) * S] = a.by[k * B + lane];
      d[(2 * nb + k) * S] = a.bg[k * B + lane];
      d[(3 * nb + k) * S] = a.bw[k * B + lane];
    }
  }
}

// The head of the launch's int buffer (`tiles`), which the launcher zeroes:
// lanes claimed past the first grid's, lanes refilled, tiles solved again,
// then per tile the most iterations a lane of it ran and (max_iters + 1 -
// the fewest) of those of its lanes that would blend after they were done.
enum { T_CLAIMED = 0, T_REFILLED, T_RETILED, kHead };

// The next lane of a slot whose lane is done: past the first grid's lanes
// (lane = slot) they go out in order from a counter. The threads of a warp
// that ask together take consecutive lanes with one atomicAdd; no thread
// waits for another that is still solving.
__device__ __forceinline__ int claim_lane(int* counter, int first) {
  const unsigned m = __activemask();
  const int me = threadIdx.x & 31;
  const int head = __ffs(m) - 1;
  int base = 0;
  if (me == head) base = atomicAdd(counter, __popc(m));
  base = __shfl_sync(m, base, head);
  return first + base + __popc(m & ((1u << me) - 1u));
}

// Whether a tile goes to the second kernel: it has a lane that blends after
// it is done (dirty, or its probe was not finite) and that ran fewer
// iterations than the tile's most, so that the tile outlived it.
__device__ __forceinline__ bool tile_outlives(const Args& a, int tile) {
  const int* most = a.tiles + kHead;
  const int tied = most[(a.B + kTile - 1) / kTile + tile];
  return tied > 0 && a.max_iters + 1 - tied < most[tile];
}

// The persistent grid's next lane for a slot under the second kernel: the
// slot's lanes are slot, slot + slots, ..., each tile's at the same
// thread, and those of tiles that did not outlive a blending lane are
// skipped.
__device__ __forceinline__ int next_retiled(const Args& a, int lane) {
  while (lane < a.B && !tile_outlives(a, lane / kTile)) lane += a.slots;
  return lane;
}

// The persistent grid (the launch's slots threads, stride a.slots over
// the working set): one trip runs one SQP iteration of the slot's lane,
// split into three phases that the warp's threads run together whatever
// lane and iteration each holds: (1) the last iteration's re-roll and
// bookkeeping, or a fresh lane's initial rollout (the same steps under the
// input's controls); (2) the backward; (3) the line search. A lane that
// is done, or at the cap, runs one more backward (2) with its warp-mates,
// which streams its trajectory into the lane-major outputs and, for a lane
// done before the cap with a finite `dirt`, is its probe (see the
// per-thread SQP loop in solve_mega_kernel);
// then it retires in (3), and the slot takes the next lane, loaded now
// and started on the next trip. No thread waits for another, so no warp or
// block runs to its slowest lane.
//
// A lane that blends after it is done does so for as many iterations as
// its tile (TILE lanes) ran after it, so its result depends on its tile.
// The first kernel (RETILE false) takes lanes in order from a counter and
// records per tile the most iterations a lane ran and the fewest that a
// blending lane ran; the second (RETILE true) solves every tile that
// outlived a blending lane again, where such a lane, instead of retiring,
// goes on through its line search with act = 0 until it has run the
// tile's most: the TPU kernel's and the plain version's per-tile blend.
// The inputs are never written and every other lane's result is its own,
// so those come out of the second solve as out of the first.
template <int NLS, bool DDP, bool FAST, bool ADAPT, bool BLOBS, bool SETP,
          bool BICYCLE, bool RETILE>
__device__ __forceinline__ void grid_loop(const Args& a) {
  Solve<NLS, DDP, FAST, ADAPT, BLOBS, SETP, BICYCLE> sv;
  const int slot = blockIdx.x * kTile + threadIdx.x;
  int* most = a.tiles + kHead;
  int* tied_fewest = most + (a.B + kTile - 1) / kTile;
  by_slot(sv, a, slot);
  int lane = RETILE ? next_retiled(a, slot) : slot;
  int it = 0;
  // fresh: the slot's lane has just been taken and loaded; else its last
  // trip ended with a line search
  bool fresh = true;
  auto take = [&]() {
    if (lane >= a.B) return;
    if (RETILE && lane % kTile == 0) atomicAdd(a.tiles + T_RETILED, 1);
    stage_extras<BLOBS, SETP>(sv.ex, a, lane);
    sv.load(a, lane);
  };
  take();
  // the warp's threads that still hold a lane: each trip starts with them
  // reconverged, so that each phase runs once for the whole warp
  unsigned alive = __activemask();
  for (;;) {
    alive = __ballot_sync(alive, lane < a.B);
    if (lane >= a.B) break;
    // (1), one call of the rollout for both: the input's controls, or the
    // winner's recorded ones
    const bool blend = !fresh && !(fabsf(sv.chk) <= kFloatMax);
    float trail = 0.0f;
    if (blend) trail = sv.blend();
    if (fresh || sv.replays())
      trail = sv.rollout(
          fresh ? a.u0 + lane : sv.L.cu + sv.win * a.T * 2 * a.slots,
          fresh ? a.B : a.slots, fresh);
    if (fresh) {
      sv.start(trail);
      it = 0;
      fresh = false;
    } else {
      sv.settle(a, trail);
      ++it;
    }
    __syncwarp(alive);
    // (2)
    const bool live = it < a.max_iters;
    const bool run = live && sv.done < 0.5f;
    sv.backward(a, run ? nullptr : a.ss + lane * (a.T + 1) * 8);
    // a lane done before the cap whose dirt is finite has just run its
    // probe; it blends after it is done if that was not finite, and a
    // dirty lane does
    const bool probe = live && fabsf(sv.dirt) <= kFloatMax;
    const bool tied = !run && (probe ? !(fabsf(sv.chk) <= kFloatMax) : live);
    const bool stays = RETILE && tied && it < most[lane / kTile];
    // (3)
    if (run || stays) {
      sv.search(a, lane);
    } else {
      sv.put_scalars(a, lane);
      if (!RETILE) {
        atomicMax(&most[lane / kTile], it);
        if (tied)
          atomicMax(&tied_fewest[lane / kTile], a.max_iters + 1 - it);
      }
      lane = RETILE ? next_retiled(a, lane + a.slots)
                    : claim_lane(a.tiles + T_CLAIMED, a.slots);
      take();
      fresh = true;
    }
  }
}

template <int NLS, bool DDP, bool FAST, bool ADAPT, bool TILE_EXIT,
          bool BLOBS, bool SETP, bool BICYCLE, bool REFILL>
__global__ void __launch_bounds__(kTile)
    solve_mega_kernel(const Args a) {
  if constexpr (REFILL) {
    grid_loop<NLS, DDP, FAST, ADAPT, BLOBS, SETP, BICYCLE, false>(a);
  } else {
    lane_loop<NLS, DDP, FAST, ADAPT, TILE_EXIT, BLOBS, SETP, BICYCLE>(a);
  }
}

// The persistent grid's second kernel (see grid_loop), on the same slots
// after the first; it also reports the first's refilled lanes.
template <int NLS, bool DDP, bool FAST, bool ADAPT, bool BLOBS, bool SETP,
          bool BICYCLE>
__global__ void __launch_bounds__(kTile)
    solve_mega_retile(const Args a) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    a.tiles[T_REFILLED] = min(a.tiles[T_CLAIMED], max(a.B - a.slots, 0));
  grid_loop<NLS, DDP, FAST, ADAPT, BLOBS, SETP, BICYCLE, true>(a);
}

}  // namespace mega

// Each build instantiates one variant of the template, chosen by these
// macros (kernels/_build.py passes them; the defaults are the production
// N=30 configuration).
#ifndef MEGA_NLS
#define MEGA_NLS 4
#endif
#ifndef MEGA_DDP
#define MEGA_DDP 1
#endif
#ifndef MEGA_FAST
#define MEGA_FAST 1
#endif
#ifndef MEGA_ADAPT
#define MEGA_ADAPT 1
#endif
#ifndef MEGA_TILE_EXIT
#define MEGA_TILE_EXIT 0
#endif
#ifndef MEGA_BLOBS
#define MEGA_BLOBS 0
#endif
#ifndef MEGA_SETP
#define MEGA_SETP 0
#endif
#ifndef MEGA_BICYCLE
#define MEGA_BICYCLE 0
#endif

// Error codes for a request of a variant this library was not built for,
// for a per-tile exit over a batch that is not whole tiles, for a
// variant's input that is missing, and for a persistent grid this library
// cannot launch.
#define MEGA_ERR_VARIANT 100000
#define MEGA_ERR_TILE 100001
#define MEGA_ERR_INPUT 100002
#define MEGA_ERR_SLOTS 100003

// the instantiations this library holds: one lane per thread, and (for
// the per-thread exit) the persistent grid and its tiles' second solve
#define MEGA_KERNEL                                                      \
  mega::solve_mega_kernel<MEGA_NLS, MEGA_DDP != 0, MEGA_FAST != 0,      \
                          MEGA_ADAPT != 0, MEGA_TILE_EXIT != 0,         \
                          MEGA_BLOBS != 0, MEGA_SETP != 0,              \
                          MEGA_BICYCLE != 0, false>
#define MEGA_REFILL                                                      \
  mega::solve_mega_kernel<MEGA_NLS, MEGA_DDP != 0, MEGA_FAST != 0,      \
                          MEGA_ADAPT != 0, false, MEGA_BLOBS != 0,      \
                          MEGA_SETP != 0, MEGA_BICYCLE != 0, true>
#define MEGA_RETILE                                                      \
  mega::solve_mega_retile<MEGA_NLS, MEGA_DDP != 0, MEGA_FAST != 0,      \
                          MEGA_ADAPT != 0, MEGA_BLOBS != 0,             \
                          MEGA_SETP != 0, MEGA_BICYCLE != 0>

// `slots` = 0 launches one thread per lane; slots > 0 (a multiple of
// kTile, no more than the card holds at once: solve_mega.refill_slots)
// launches the persistent grid of that many threads over the working set
// `work` and the int buffer `tiles` (kHead + 2 ceil(B / kTile) ints, zeroed
// here), then the tiles' second solve. The persistent grid's outputs are
// lane-major: ss (B, T+1, 8), whose rows 6-7 of knots 1..T are us (the
// pointer us is not used), and the six per-lane outputs the columns of a
// (B, 6) array (cost the first, done the last). `tile_shift` (the
// per-tile exit only, else 0) starts the blocks at that tile: block b
// solves tile (b + tile_shift) mod B / kTile.
extern "C" int mpc_solve_mega_f32(
    const void* z0, const void* cf, const void* par, const void* lb,
    const void* ub, const void* u0, const void* resume, const void* setp,
    const void* bx, const void* by, const void* bg, const void* bw,
    void* ss, void* us, void* cost, void* conv, void* iters, void* gnorm,
    void* mu, void* done, void* diag, void* traj_g, void* ks, void* Ks,
    void* cand_u, void* work, void* tiles, int P, int B, int T,
    int max_iters, int n_done_needed, int n_blobs, int slots,
    int tile_shift, float sign,
    float tol_grad, float tol_cost_eff, float mu_min, float mu_max,
    float mu_factor, float ddp_gate, int n_ls, int ddp, int fast,
    int adaptive, int tile_exit, int blobs, int setp_on, int bicycle,
    void* stream) {
  if (n_ls != MEGA_NLS || (ddp != 0) != (MEGA_DDP != 0) ||
      (fast != 0) != (MEGA_FAST != 0) ||
      (adaptive != 0) != (MEGA_ADAPT != 0) ||
      (tile_exit != 0) != (MEGA_TILE_EXIT != 0) ||
      (blobs != 0) != (MEGA_BLOBS != 0) ||
      (setp_on != 0) != (MEGA_SETP != 0) ||
      (bicycle != 0) != (MEGA_BICYCLE != 0))
    return MEGA_ERR_VARIANT;
  if (MEGA_TILE_EXIT != 0 && B % mega::kTile != 0) return MEGA_ERR_TILE;
  if (tile_shift < 0 ||
      (tile_shift > 0 &&
       (MEGA_TILE_EXIT == 0 || tile_shift >= B / mega::kTile)))
    return MEGA_ERR_TILE;
  if (MEGA_BLOBS != 0 && (n_blobs < 1 || bx == nullptr || by == nullptr ||
                          bg == nullptr || bw == nullptr))
    return MEGA_ERR_INPUT;
  if (MEGA_SETP != 0 && setp == nullptr) return MEGA_ERR_INPUT;
  if (slots < 0 || slots % mega::kTile != 0 ||
      (slots > 0 && (MEGA_TILE_EXIT != 0 || work == nullptr ||
                     tiles == nullptr)))
    return MEGA_ERR_SLOTS;
  mega::Args a;
  a.z0 = static_cast<const float*>(z0);
  a.cf = static_cast<const float*>(cf);
  a.par = static_cast<const float*>(par);
  a.lb = static_cast<const float*>(lb);
  a.ub = static_cast<const float*>(ub);
  a.u0 = static_cast<const float*>(u0);
  a.resume = static_cast<const float*>(resume);
  a.ss = static_cast<float*>(ss);
  a.us = static_cast<float*>(us);
  a.cost = static_cast<float*>(cost);
  a.conv = static_cast<float*>(conv);
  a.iters = static_cast<float*>(iters);
  a.gnorm = static_cast<float*>(gnorm);
  a.mu = static_cast<float*>(mu);
  a.done = static_cast<float*>(done);
  a.diag = static_cast<float*>(diag);
  a.traj_g = static_cast<float*>(traj_g);
  a.ks = static_cast<float*>(ks);
  a.Ks = static_cast<float*>(Ks);
  a.cand_u = static_cast<float*>(cand_u);
  a.P = P;
  a.B = B;
  a.T = T;
  a.max_iters = max_iters;
  a.n_done_needed = n_done_needed;
  a.tile_shift = tile_shift;
  a.sign = sign;
  a.tol_grad = tol_grad;
  a.tol_cost_eff = tol_cost_eff;
  a.mu_min = mu_min;
  a.mu_max = mu_max;
  a.mu_factor = mu_factor;
  a.ddp_gate = ddp_gate;
  a.setp = static_cast<const float*>(setp);
  a.bx = static_cast<const float*>(bx);
  a.by = static_cast<const float*>(by);
  a.bg = static_cast<const float*>(bg);
  a.bw = static_cast<const float*>(bw);
  a.n_blobs = n_blobs;
  a.work = static_cast<float*>(work);
  a.tiles = static_cast<int*>(tiles);
  a.slots = slots;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = mega::kTile;
#if MEGA_TILE_EXIT == 0
  if (slots > 0) {
    // the knot ring's dynamic shared memory
    cudaError_t set = cudaFuncSetAttribute(
        MEGA_REFILL, cudaFuncAttributeMaxDynamicSharedMemorySize,
        mega::kRingBytes);
    if (set == cudaSuccess)
      set = cudaFuncSetAttribute(MEGA_RETILE,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 mega::kRingBytes);
    if (set == cudaSuccess)
      set = cudaMemsetAsync(
          tiles, 0, (mega::kHead + 2 * ((B + threads - 1) / threads)) *
                        sizeof(int), st);
    if (set != cudaSuccess) return static_cast<int>(set);
    MEGA_REFILL<<<slots / threads, threads, mega::kRingBytes, st>>>(a);
    MEGA_RETILE<<<slots / threads, threads, mega::kRingBytes, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
#endif
  // the knot ring's dynamic shared memory
  const cudaError_t set = cudaFuncSetAttribute(
      MEGA_KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mega::kRingBytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (B + threads - 1) / threads;
  MEGA_KERNEL<<<blocks, threads, mega::kRingBytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// What this variant occupies on the current device: out = (registers per
// thread, local memory bytes per thread, dynamic shared memory bytes per
// block, resident blocks per SM at that shared memory) of the
// one-lane-per-thread kernel, then (registers, local memory bytes, resident
// blocks per SM) of the persistent grid's (zeros for a per-tile exit).
template <class K>
static cudaError_t mega_occupancy(K kernel, int smem, int* out, bool ring) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      mega::kTile, smem);
  if (err != cudaSuccess) return err;
  *out++ = attr.numRegs;
  *out++ = static_cast<int>(attr.localSizeBytes);
  if (ring) *out++ = smem;
  *out = blocks;
  return cudaSuccess;
}

extern "C" int mpc_solve_mega_occupancy(int* out) {
  cudaError_t err = mega_occupancy(MEGA_KERNEL, mega::kRingBytes, out, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[4] = out[5] = out[6] = 0;
#if MEGA_TILE_EXIT == 0
  err = mega_occupancy(MEGA_REFILL, mega::kRingBytes, out + 4, false);
#endif
  return static_cast<int>(err);
}

extern "C" const char* mpc_cuda_error_string(int err) {
  if (err == MEGA_ERR_VARIANT)
    return "library built for another (n_ls, ddp, fast, adaptive, "
           "tile_exit, blobs, setp, bicycle) variant";
  if (err == MEGA_ERR_TILE)
    return "done_frac < 1 exits per 128-lane tile and needs B % 128 == 0 "
           "and a tile shift in [0, B / 128); one thread per lane takes none";
  if (err == MEGA_ERR_INPUT)
    return "the blobs variant needs n_blobs >= 1 and its four arrays, the "
           "setp variant its profile";
  if (err == MEGA_ERR_SLOTS)
    return "the persistent grid takes slots a multiple of 128, its working "
           "set and tile buffer, and a per-thread exit";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
