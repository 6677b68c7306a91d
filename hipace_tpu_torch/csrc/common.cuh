// Shared device helpers for the port's kernels: B-spline shape factors
// (port of hipace_tpu/ops/shape.py and the window weight function _wfun of
// hipace_tpu/ops/pallas_banded.py:86-112).
#pragma once

#include <cuda_runtime.h>

namespace hipace {

// stencil width: deriv_type -1 is the plain order-p shape
__host__ __device__ __forceinline__ int ntaps(int order, int deriv_type) {
    return deriv_type < 0 ? order + 1 : order + deriv_type + 1;
}

template <typename T>
__device__ __forceinline__ T bspline(T u, int p) {
    T au = u < T(0) ? -u : u;
    if (p == 0) return (u >= T(-0.5) && u < T(0.5)) ? T(1) : T(0);
    if (p == 1) return au < T(1) ? T(1) - au : T(0);
    if (p == 2) {
        if (au <= T(0.5)) return T(0.75) - au * au;
        T t = T(1.5) - au;
        return au < T(1.5) ? T(0.5) * (t * t) : T(0);
    }
    // p == 3
    if (au <= T(1)) return (T(4) - T(6) * au * au + T(3) * (au * au * au)) / T(6);
    T t = T(2) - au;
    return au < T(2) ? t * t * t / T(6) : T(0);
}

template <typename T>
__device__ __forceinline__ T bspline_deriv(T u, int p) {
    return bspline(u + T(0.5), p - 1) - bspline(u - T(0.5), p - 1);
}

template <typename T>
__device__ __forceinline__ int leftmost(T x, int p) {
    if (p == 0 || p == 2) return int(floor(x + T(0.5))) - p / 2;
    return int(floor(x)) - (p - 1) / 2;
}

template <typename T>
__device__ __forceinline__ int stencil_i0(T x, int order, int deriv_type) {
    if (deriv_type == 1) return leftmost(x, order + 1);
    if (deriv_type == 2) return leftmost(x, order) - 1;
    return leftmost(x, order);   // -1 and 0
}

// weight at offset u = pos - cell; kind 0 = shape "w", 1 = derivative "dw"
template <typename T>
__device__ __forceinline__ T wfun(T u, int order, int deriv_type, int kind) {
    if (kind == 0) return bspline(u, order);
    if (deriv_type == 0) return -bspline_deriv(u, order);
    if (deriv_type == 1) return -bspline_deriv(u, order + 1);
    return T(0.5) * (bspline(u - T(1), order) - bspline(u + T(1), order));
}

// lanes at or beyond this guard-offset row position are dead (sentinel
// 2*NY; NaN positions are dead too since the comparison fails)
template <typename T>
__device__ __forceinline__ bool live_lane(T ym, int NY) {
    return ym < T(1.5) * T(NY);
}

constexpr int kMaxTaps = 6;   // order 3, centered derivative

}  // namespace hipace
