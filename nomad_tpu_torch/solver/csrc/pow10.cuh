// 10**x for the placement kernels (K1 depth_curve.cu, K2 score_capacity.cu).
//
// The result is defined by the plain version (kernels._pow10): 10**x
// evaluated in float64 and rounded once to float32, pow10_ref below. That
// rounding is what every CPU parity test holds against the JAX package, so
// both kernels take 10**x from here and nothing else computes it on the
// card.
//
// pow10_f32 returns exactly pow10_ref(x) for every float32 x, faster. The
// float64 pow() spends most of its work on an extra-precise log; the
// kernels need the float32 rounding only, which a cheaper estimate decides
// almost always (a Ziv-style test):
//   r = exp2((double)x * log2(10)) is within 2^-44 of 10**x, relative (the
//       product's two roundings, 2^-53 each, times |x log2 10| <= 153, and
//       exp2's 1 ulp); pow() is within 2 ulp of 10**x.
//   Both therefore lie in [r (1 - 2^-40), r (1 + 2^-40)]. Rounding to
//   float32 is monotone, so where both ends of that interval round to the
//   same float32, so does pow(): that float32 is the answer. Otherwise (a
//   rounding boundary lies within 2^-40 of r: about one input in 10^5) the
//   float64 pow decides.
// The estimate covers x in [-46, 1]; below -46, 10**x < 1e-46 rounds to 0
// (the smallest float32 is 1.4e-45); above 1 and for NaN pow() is used.
// chip_smoke.py's pow10 phase runs pow10_check.cu over every float32 in
// [-46, 1], and every float32 below -46, and requires 0 mismatches.

#pragma once

// the reference: 10**x in float64, rounded once to float32
__device__ __forceinline__ float pow10_ref(float x) {
  return (float)pow(10.0, (double)x);
}

// true, with *out = pow10_ref(x), where the cheap estimate decides the
// rounding; false where pow10_ref has to
__device__ __forceinline__ bool pow10_estimate(float x, float* out) {
  if (!(x <= 1.0f)) return false;              // x > 1, or NaN
  if (x < -46.0f) {
    *out = 0.0f;
    return true;
  }
  const double kLog2Ten = 3.3219280948873623478703194294894;
  const double kSlack = 0x1p-40;
  double r = exp2((double)x * kLog2Ten);
  float lo = __double2float_rn(r * (1.0 - kSlack));
  float hi = __double2float_rn(r * (1.0 + kSlack));
  *out = lo;
  return lo == hi;
}

__device__ __forceinline__ float pow10_f32(float x) {
  float y;
  if (pow10_estimate(x, &y)) return y;
  return pow10_ref(x);
}
