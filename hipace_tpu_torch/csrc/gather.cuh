// K2's per-lane gather, shared by K2 (gather.cu) and the fused beam push
// (beam_push.cu): from the five field planes Psi, Ez, Bx, By, Bz with nodal
// (deriv_type 1) order-P weights, the raw Psi derivatives sum(Wy dWx Psi) and
// sum(dWy Wx Psi) and Ez, Bx, By, Bz interpolated with Wy Wx (ref
// FieldGather.H:45-97). The design notes are gather.cu's.
#pragma once

#include "common.cuh"

namespace hipace {

constexpr int kPlanes = 5;                     // Psi, Ez, Bx, By, Bz
constexpr int kOut = 6;                        // the six sums per lane

template <typename T>
struct Planes {
    const T* f[kPlanes];   // each (NY, NX), row-major, NY * NX < 2^31
};

// the lane's stencil origin; false for a dead lane or one whose every tap
// lies outside the grid (its sums are 0)
template <int P, typename T>
__device__ __forceinline__ bool stencil_live(T y, T x, int NY, int NX, int& iy0, int& ix0) {
    constexpr int m = P + 2;
    if (!live_lane(y, NY)) return false;
    iy0 = leftmost(y, P + 1);
    ix0 = leftmost(x, P + 1);
    return iy0 > -m && iy0 < NY && ix0 > -m && ix0 < NX;
}

// nodal order-P weights of tap k, u = x - (i0 + k): w = B_P(u) and
// dw = -B_{P+1}'(u) = B_P(u - 1/2) - B_P(u + 1/2)
template <int P, typename T>
__device__ __forceinline__ void nodal_weight(T u, T& w, T& dw) {
    w = bspline_p<P>(u);
    dw = bspline_p<P>(u - T(0.5)) - bspline_p<P>(u + T(0.5));
}

// the six sums over the (P+2)^2 taps of a lane at row position y, from its
// column weights; load(a, b, v) fetches the five plane values of tap (a, b).
// Rows outside [0, NY) weigh 0.
template <int P, typename T, typename Load>
__device__ __forceinline__ void sum_taps(T y, int iy0, int NY, const T (&wx)[P + 2],
                                         const T (&dwx)[P + 2], Load load, T (&acc)[kOut]) {
#pragma unroll
    for (int a = 0; a < P + 2; ++a) {
        T r[kOut];
#pragma unroll
        for (int c = 0; c < kOut; ++c) r[c] = T(0);
#pragma unroll
        for (int b = 0; b < P + 2; ++b) {
            T v[kPlanes];
            load(a, b, v);
            r[0] += dwx[b] * v[0];
            r[1] += wx[b] * v[0];
#pragma unroll
            for (int c = 1; c < kPlanes; ++c) r[c + 1] += wx[b] * v[c];
        }
        T wy, dwy;
        nodal_weight<P>(y - T(iy0 + a), wy, dwy);
        if (iy0 + a < 0 || iy0 + a >= NY) wy = dwy = T(0);
        acc[0] += wy * r[0];
        acc[1] += dwy * r[1];
#pragma unroll
        for (int c = 2; c < kOut; ++c) acc[c] += wy * r[c];
    }
}

// one live lane, its taps read straight from the planes
template <int P, typename T>
__device__ __forceinline__ void gather_lane(const Planes<T> pl, T y, T x, int iy0, int ix0,
                                            int NY, int NX, T (&acc)[kOut]) {
    constexpr int m = P + 2;
    T wx[m], dwx[m];
#pragma unroll
    for (int k = 0; k < m; ++k) nodal_weight<P>(x - T(ix0 + k), wx[k], dwx[k]);
    if (iy0 >= 0 && iy0 <= NY - m && ix0 >= 0 && ix0 <= NX - m) {
        const int base = iy0 * NX + ix0;
        sum_taps<P>(y, iy0, NY, wx, dwx, [&](int a, int b, T (&v)[kPlanes]) {
            const int off = base + a * NX + b;
#pragma unroll
            for (int c = 0; c < kPlanes; ++c) v[c] = __ldg(pl.f[c] + off);
        }, acc);
    } else {   // near the edge: clamp each tap, and drop the columns outside
#pragma unroll
        for (int k = 0; k < m; ++k)
            if (ix0 + k < 0 || ix0 + k >= NX) wx[k] = dwx[k] = T(0);
        sum_taps<P>(y, iy0, NY, wx, dwx, [&](int a, int b, T (&v)[kPlanes]) {
            const int off = min(max(iy0 + a, 0), NY - 1) * NX + min(max(ix0 + b, 0), NX - 1);
#pragma unroll
            for (int c = 0; c < kPlanes; ++c) v[c] = __ldg(pl.f[c] + off);
        }, acc);
    }
}

}  // namespace hipace
