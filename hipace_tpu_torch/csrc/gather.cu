// K2: fused main-fields gather. Per particle, from a (5, NY, NX) stack
// [Psi, Ez, Bx, By, Bz] with nodal (deriv_type 1) order-p weights: the raw
// Psi derivatives sum(Wy dWx Psi) and sum(dWy Wx Psi), which the caller
// scales by 1/dx and 1/dy into ExmBy and EypBx, and Ez, Bx, By, Bz
// interpolated with Wy Wx (ref FieldGather.H:45-97).
//
// Replaces the TPU kernel _gather_main_kernel / _gather_main_body, launched
// by pallas_gather_main (hipace_tpu/ops/pallas_banded.py:546-748). Taps
// outside the grid are dropped; dead lanes (row position at or beyond
// 1.5*NY, the sentinel convention) output 0.
//
// What bounds it on the H100: the (p+2)^2 x 5 scattered reads per particle
// (80 loads at order 2). Particles arrive in init order (x fastest, then
// y), so neighbouring threads read neighbouring cells, and the five field
// planes of a slice are small enough to stay in the L2 cache. The TPU
// kernel's W-row/WXS windows, roll trick, bf16x3 dots and corrective
// while_loop only kept it exact inside fixed windows; a thread that reads
// its own taps is exact for every lane. Design: one thread per particle,
// weights in registers, six outputs written coalesced.

#include "common.cuh"

namespace hipace {

template <typename T>
__global__ void gather_main_kernel(T* __restrict__ out,
                                   const T* __restrict__ stack,
                                   const T* __restrict__ ym,
                                   const T* __restrict__ xm, long long N,
                                   int NY, int NX, int order) {
    long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= N) return;
    T y = ym[p];
    T x = xm[p];
    T e = 0, ps = 0, ez = 0, bx = 0, by = 0, bz = 0;
    if (live_lane(y, NY)) {
        const int m = order + 2;
        const int iy0 = leftmost(y, order + 1);
        const int ix0 = leftmost(x, order + 1);
        T wy[kMaxTaps], dwy[kMaxTaps], wx[kMaxTaps], dwx[kMaxTaps];
        for (int k = 0; k < m; ++k) {
            T uy = y - T(iy0 + k);
            T ux = x - T(ix0 + k);
            wy[k] = bspline(uy, order);
            dwy[k] = -bspline_deriv(uy, order + 1);
            wx[k] = bspline(ux, order);
            dwx[k] = -bspline_deriv(ux, order + 1);
        }
        const long long plane = (long long)NY * NX;
        for (int a = 0; a < m; ++a) {
            const int row = iy0 + a;
            if (row < 0 || row >= NY) continue;
            for (int b = 0; b < m; ++b) {
                const int col = ix0 + b;
                if (col < 0 || col >= NX) continue;
                const T* s = stack + (long long)row * NX + col;
                const T w = wy[a] * wx[b];
                const T psi = s[0];
                e += wy[a] * dwx[b] * psi;
                ps += dwy[a] * wx[b] * psi;
                ez += w * s[plane];
                bx += w * s[2 * plane];
                by += w * s[3 * plane];
                bz += w * s[4 * plane];
            }
        }
    }
    out[p] = e;
    out[N + p] = ps;
    out[2 * N + p] = ez;
    out[3 * N + p] = bx;
    out[4 * N + p] = by;
    out[5 * N + p] = bz;
}

template <typename T>
int launch_gather_main(void* out, const void* stack, const void* ym,
                       const void* xm, long long N, int NY, int NX, int order,
                       void* stream) {
    if (N > 0) {
        const int block = 256;
        const long long grid = (N + block - 1) / block;
        gather_main_kernel<T><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
            (T*)out, (const T*)stack, (const T*)ym, (const T*)xm, N, NY, NX,
            order);
    }
    return (int)cudaGetLastError();
}

}  // namespace hipace

extern "C" {
int hipace_gather_main_f32(void* out, const void* stack, const void* ym,
                           const void* xm, long long N, int NY, int NX,
                           int order, void* stream) {
    return hipace::launch_gather_main<float>(out, stack, ym, xm, N, NY, NX,
                                             order, stream);
}
int hipace_gather_main_f64(void* out, const void* stack, const void* ym,
                           const void* xm, long long N, int NY, int NX,
                           int order, void* stream) {
    return hipace::launch_gather_main<double>(out, stack, ym, xm, N, NY, NX,
                                              order, stream);
}
}
