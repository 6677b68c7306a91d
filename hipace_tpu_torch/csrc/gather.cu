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

#include "gather.cuh"

#include <climits>

namespace hipace {

constexpr int kBlock = 128;                    // lanes per block

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
