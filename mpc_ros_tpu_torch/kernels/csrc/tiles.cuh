// Per-scenario device helpers of the solve kernel (solve_mega.cu).
//
// Replaces the Pallas tile helpers of mpc_ros_tpu/kernels/backward_pallas.py
// (_polyval_tile, _polyder_tile, _polyder2_tile, _mtm/_mtv/_mv, _boxqp_tile).
// On the TPU each helper worked on (sub, 128) tiles of lanes; here one
// thread owns one scenario, so every helper is scalar code on registers.
// The small matrix products are written out inline at their call sites.
// kernels/tiles.py holds the plain PyTorch versions, with the same
// operation order.
#pragma once

namespace mega {

// Largest polynomial the kernel takes (P <= 8 coefficients, order 7); the
// coefficients sit in registers, indexed only by unrolled constants.
constexpr int kPMax = 8;

// max(a, b) and min(a, b) that return NaN when either operand is NaN, as
// torch.maximum / torch.minimum / torch.clamp and jnp.maximum / jnp.clip
// do (fmaxf / fminf return the other operand). On the card one PTX
// max.NaN / min.NaN instruction each (sm_80 and later); elsewhere (a host
// compiler rehearsing the kernel) the same rule in C.
__device__ __forceinline__ float maxf(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || b != b) ? a + b : fmaxf(a, b);
#endif
}

__device__ __forceinline__ float minf(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || b != b) ? a + b : fminf(a, b);
#endif
}

__device__ __forceinline__ float pos(float x) { return maxf(x, 0.0f); }

// clip(x, lo, hi) = min(max(x, lo), hi), NaN in any operand giving NaN
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return minf(maxf(x, lo), hi);
}

// f(x) = sum_i c[i] x^i, Horner from the top: acc = c[P-1];
// acc = c[i] + x * acc for i = P-2 .. 0.
__device__ __forceinline__ float polyval(const float (&c)[kPMax], int P,
                                         float x) {
  float acc = 0.0f;
#pragma unroll
  for (int i = kPMax - 1; i >= 0; --i) {
    if (i < P) acc = (i == P - 1) ? c[i] : c[i] + x * acc;
  }
  return acc;
}

// f'(x): acc = (P-1) c[P-1]; acc = i c[i] + x * acc for i = P-2 .. 1.
__device__ __forceinline__ float polyder(const float (&c)[kPMax], int P,
                                         float x) {
  float acc = 0.0f;
#pragma unroll
  for (int i = kPMax - 1; i >= 1; --i) {
    if (i < P) {
      acc = (i == P - 1) ? static_cast<float>(i) * c[i]
                         : static_cast<float>(i) * c[i] + x * acc;
    }
  }
  return acc;
}

// f''(x): acc = (P-1)(P-2) c[P-1]; acc = i(i-1) c[i] + x * acc, i >= 2.
__device__ __forceinline__ float polyder2(const float (&c)[kPMax], int P,
                                          float x) {
  float acc = 0.0f;
#pragma unroll
  for (int i = kPMax - 1; i >= 2; --i) {
    if (i < P) {
      acc = (i == P - 1) ? static_cast<float>(i * (i - 1)) * c[i]
                         : static_cast<float>(i * (i - 1)) * c[i] + x * acc;
    }
  }
  return acc;
}

// Exact 2-D box QP: min 0.5 d'Q d + q'd over l <= d <= h, Q = [[a, b],
// [c, d]], by enumerating the 9 clamp combos (free / at lower / at upper
// per control) in the order of itertools.product(range(3), repeat=2).
// A clamped control collapses the 2x2 solve to a 1-D (or 0-D) closed
// form, so the enumeration takes three reciprocals (1/a, 1/d, 1/det).
// The winner is the first combo with the least KKT violation (ties by
// combo order; the 1e-12 / 2e-12 terms prefer fewer clamps). Returns the
// step (k0, k1) and the selected inverse entries (j00, j01, j10, j11):
// the gain is K = -[[j00, j01], [j10, j11]] Qus, assembled by the caller.
__device__ __forceinline__ void boxqp(float a, float b, float c, float d,
                                      float q0, float q1, float l0, float l1,
                                      float h0, float h1, float& k0,
                                      float& k1, float& j00, float& j01,
                                      float& j10, float& j11) {
  const float det = a * d - b * c;
  const float rdet = 1.0f / det;
  const float ra = 1.0f / a;
  const float rd = 1.0f / d;
  const float i00 = d * rdet, i01 = -b * rdet;
  const float i10 = -c * rdet, i11 = a * rdet;

  float cd0[9], cd1[9], cv[9];
#pragma unroll
  for (int idx = 0; idx < 9; ++idx) {
    const int c0 = idx / 3, c1 = idx % 3;
    float d0, d1, viol;
    if (c0 == 0 && c1 == 0) {
      d0 = -(i00 * q0 + i01 * q1);
      d1 = -(i10 * q0 + i11 * q1);
      viol = pos(l0 - d0) + pos(d0 - h0) + pos(l1 - d1) + pos(d1 - h1);
    } else if (c0 == 0) {  // u1 clamped, u0 free
      d1 = (c1 == 1) ? l1 : h1;
      d0 = -(q0 + b * d1) * ra;
      const float lam1 = q1 + c * d0 + d * d1;
      viol = pos(l0 - d0) + pos(d0 - h0) + pos(c1 == 1 ? -lam1 : lam1) +
             1e-12f;
    } else if (c1 == 0) {  // u0 clamped, u1 free
      d0 = (c0 == 1) ? l0 : h0;
      d1 = -(q1 + c * d0) * rd;
      const float lam0 = q0 + a * d0 + b * d1;
      viol = pos(l1 - d1) + pos(d1 - h1) + pos(c0 == 1 ? -lam0 : lam0) +
             1e-12f;
    } else {  // both clamped
      d0 = (c0 == 1) ? l0 : h0;
      d1 = (c1 == 1) ? l1 : h1;
      const float lam0 = q0 + a * d0 + b * d1;
      const float lam1 = q1 + c * d0 + d * d1;
      viol = pos(c0 == 1 ? -lam0 : lam0) + pos(c1 == 1 ? -lam1 : lam1) +
             2e-12f;
    }
    cd0[idx] = d0;
    cd1[idx] = d1;
    cv[idx] = viol;
  }
  float best = cv[0];
#pragma unroll
  for (int idx = 1; idx < 9; ++idx) best = minf(best, cv[idx]);

  float picked = 0.0f;
  k0 = k1 = 0.0f;
  j00 = j01 = j10 = j11 = 0.0f;
#pragma unroll
  for (int idx = 0; idx < 9; ++idx) {
    const int c0 = idx / 3, c1 = idx % 3;
    const float sel = (cv[idx] <= best && picked < 0.5f) ? 1.0f : 0.0f;
    picked = picked + sel;
    k0 = k0 + sel * cd0[idx];
    k1 = k1 + sel * cd1[idx];
    if (c0 == 0 && c1 == 0) {
      j00 = j00 + sel * i00;
      j01 = j01 + sel * i01;
      j10 = j10 + sel * i10;
      j11 = j11 + sel * i11;
    } else if (c0 == 0) {  // only u0 free: row 0 = -Qus[0] / a
      j00 = j00 + sel * ra;
    } else if (c1 == 0) {  // only u1 free: row 1 = -Qus[1] / d
      j11 = j11 + sel * rd;
    }
  }
}

}  // namespace mega
