// K2: fused main-fields gather. Per particle, from the five field planes
// Psi, Ez, Bx, By, Bz with nodal (deriv_type 1) order-p weights: the raw Psi
// derivatives sum(Wy dWx Psi) and sum(dWy Wx Psi), which the caller scales by
// 1/dx and 1/dy into ExmBy and EypBx, and Ez, Bx, By, Bz interpolated with
// Wy Wx (ref FieldGather.H:45-97). The planes come as five pointers, so the
// caller's planes are read where they lie; nothing is stacked first.
//
// Replaces the TPU kernel _gather_main_kernel / _gather_main_body, launched by
// pallas_gather_main (hipace_tpu/ops/pallas_banded.py:546-748, entry :663).
// Taps outside the grid are dropped; dead lanes (row position at or beyond
// 1.5*NY, the sentinel convention) output 0. At order 3 it follows the XLA
// gather's (p+2)-tap stencil, not the Pallas kernel's sixth tap.
//
// What bounds it on the H100: bytes. The main path's plasma call reads five
// 1027^2 planes and 1,046,529 lanes' positions and writes six values per lane,
// 54.6 MB in f32 (16 us at 3.35 TB/s), against ~0.2 GFLOP. In the way of that
// bound stand the (p+2)^2 x 5 reads per lane (80 at order 2), most of them of
// cells that the neighbouring lanes read too.
//
// Design: one thread per lane, the order a template parameter, so the weights
// sit in registers, the loops unroll and the B-spline has no branch on the
// order. Each row of taps is summed first and weighted once, and a row's
// weights are evaluated where they are used, so that few values stay live. A
// lane whose stencil lies inside the grid reads its taps with no test; a lane
// near the edge clamps each tap and zeroes the weights of the rows and
// columns outside. Lanes in init order (the plasma's) share most of their
// cells with their neighbours in the block, and L1 serves those reads. A
// shared-memory tile of each block's cells was measured against this and not
// kept: it was slower on the plasma's lanes.

#include "common.cuh"

#include <climits>

namespace hipace {

constexpr int kPlanes = 5;                     // Psi, Ez, Bx, By, Bz
constexpr int kOut = 6;                        // the six sums per lane
constexpr int kBlock = 128;                    // lanes per block

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

template <typename T>
__device__ __forceinline__ void store(T* __restrict__ out, long long p, long long N,
                                      const T (&acc)[kOut]) {
#pragma unroll
    for (int c = 0; c < kOut; ++c) out[c * N + p] = acc[c];
}

template <int P, typename T>
__global__ void __launch_bounds__(kBlock)
gather_main_kernel(T* __restrict__ out, const Planes<T> pl, const T* __restrict__ ym,
                   const T* __restrict__ xm, long long N, int NY, int NX) {
    const long long p = (long long)blockIdx.x * kBlock + threadIdx.x;
    if (p >= N) return;
    const T y = ym[p], x = xm[p];
    T acc[kOut];
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[c] = T(0);
    int iy0, ix0;
    if (stencil_live<P>(y, x, NY, NX, iy0, ix0)) gather_lane<P>(pl, y, x, iy0, ix0, NY, NX, acc);
    store(out, p, N, acc);
}

template <int P, typename T>
void launch(T* out, const Planes<T>& pl, const T* ym, const T* xm, long long N, int NY,
            int NX, cudaStream_t stream) {
    const long long grid = (N + kBlock - 1) / kBlock;
    gather_main_kernel<P, T><<<(unsigned)grid, kBlock, 0, stream>>>(out, pl, ym, xm, N, NY, NX);
}

template <typename T>
int launch_gather_main(void* out, const void* psi, const void* ez, const void* bx,
                       const void* by, const void* bz, const void* ym, const void* xm,
                       long long N, int NY, int NX, int order, void* stream) {
    if (N <= 0) return (int)cudaGetLastError();
    if ((long long)NY * NX >= INT_MAX) return (int)cudaErrorInvalidValue;
    const Planes<T> pl{{(const T*)psi, (const T*)ez, (const T*)bx, (const T*)by, (const T*)bz}};
    T* o = (T*)out;
    const T* y = (const T*)ym;
    const T* x = (const T*)xm;
    cudaStream_t s = (cudaStream_t)stream;
    switch (order) {
        case 0: launch<0>(o, pl, y, x, N, NY, NX, s); break;
        case 1: launch<1>(o, pl, y, x, N, NY, NX, s); break;
        case 2: launch<2>(o, pl, y, x, N, NY, NX, s); break;
        case 3: launch<3>(o, pl, y, x, N, NY, NX, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace hipace

#define HIPACE_GATHER_EXPORT(T, SUF)                                                   \
    int hipace_gather_main_##SUF(void* out, const void* psi, const void* ez,           \
                                 const void* bx, const void* by, const void* bz,       \
                                 const void* ym, const void* xm, long long N, int NY,  \
                                 int NX, int order, void* stream) {                    \
        return hipace::launch_gather_main<T>(out, psi, ez, bx, by, bz, ym, xm, N, NY, \
                                             NX, order, stream);                       \
    }

extern "C" {
HIPACE_GATHER_EXPORT(float, f32)
HIPACE_GATHER_EXPORT(double, f64)
}
