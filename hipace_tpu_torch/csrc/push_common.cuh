// Shared by the fused pushes (beam_push.cu, plasma_push.cu): arithmetic that
// rounds as PyTorch's elementwise ops do, and the transverse particle
// boundary of plasma.enforce_particle_bc. Each helper is one IEEE operation
// rounded to nearest (the _rn intrinsics), so that the compiler contracts no
// multiply and add where the plain version rounds twice.
#pragma once

#include <cuda_runtime.h>

namespace hipace {

enum Boundary { kPeriodic = 0, kReflecting = 1, kAbsorbing = 2 };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float fmod_t(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double fmod_t(double a, double b) { return fmod(a, b); }

// torch.remainder: the sign of the divisor (not C's remainder)
template <typename T>
__device__ __forceinline__ T floor_mod(T a, T b) {
    T mod = fmod_t(a, b);
    if (mod != T(0) && ((b < T(0)) != (mod < T(0)))) mod = add(mod, b);
    return mod;
}

// the boundary's box and its widths, in the working type
template <typename T>
struct Box {
    T lo0, lo1, hi0, hi1, lx, ly, two_lx, two_ly;
};

// plasma.enforce_particle_bc on one lane: Periodic wraps the position,
// Reflecting folds it back and flips the momentum across each wall it
// crossed, Absorbing zeroes the weight and drops the lane
template <typename T>
__device__ __forceinline__ void particle_boundary(const Box<T>& b, int boundary, T& x, T& y,
                                                  T& ux, T& uy, T& w, bool& valid) {
    const bool outside = x < b.lo0 || x > b.hi0 || y < b.lo1 || y > b.hi1;
    if (boundary == kPeriodic) {
        if (outside) {
            x = add(floor_mod(sub(x, b.lo0), b.lx), b.lo0);
            y = add(floor_mod(sub(y, b.lo1), b.ly), b.lo1);
        }
    } else if (boundary == kReflecting) {
        const T xm = floor_mod(sub(x, b.lo0), b.two_lx);
        const T ym = floor_mod(sub(y, b.lo1), b.two_ly);
        const bool refx = xm > b.lx, refy = ym > b.ly;
        if (outside) {
            x = add(refx ? sub(b.two_lx, xm) : xm, b.lo0);
            y = add(refy ? sub(b.two_ly, ym) : ym, b.lo1);
            if (refx) ux = -ux;
            if (refy) uy = -uy;
        }
    } else if (outside) {   // Absorbing
        w = T(0);
        valid = false;
    }
}

}  // namespace hipace
