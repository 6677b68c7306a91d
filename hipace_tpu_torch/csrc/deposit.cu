// K1: particle deposit, F[c, iy, ix] += v[c, p] * Wy(ym_p - iy) * Wx(xm_p - ix).
//
// Replaces the TPU kernel _deposit_kernel / _deposit_body, launched by
// _deposit_delta (hipace_tpu/ops/pallas_banded.py:254-427). The contract is
// the TPU kernel's: B-spline order 0-3; per channel a weight kind per axis,
// "w" (shape) or "dw" (derivative factor of deriv_type -1/0/1/2); guard-
// offset cell positions, with lanes at or beyond 1.5*NY dead; taps outside
// [0, NY) x [0, NX) dropped, never clamped.
//
// What bounds it on the H100: global atomics. The main-path call deposits
// 13 channels of ~1.05M plasma particles on 1023^2 with 9 nonzero taps
// each, and neighbouring particles hit the same cells, so the atomics
// contend in L2. The TPU kernel's windows, rolls, bf16x3 dots and
// corrective passes existed only to stay exact inside fixed VMEM windows;
// with global atomics every lane is exact, so none of them carry over.
// Design: one thread per particle evaluates its stencil weights once for
// both kinds and walks the channels, skipping zero-weight taps (the
// centered-derivative stencil's two end taps are zero for kind "w"), so
// the values are read coalesced and nothing is allocated. Sorted-tile
// shared-memory accumulation (ref DepositionUtil.H:40-120) is the next step.

#include "common.cuh"

namespace hipace {

template <typename T>
__global__ void deposit_kernel(T* __restrict__ fields, const T* __restrict__ ym,
                               const T* __restrict__ xm,
                               const T* __restrict__ values, int C, long long N,
                               int NY, int NX, int order, int deriv_type,
                               unsigned int ykind_mask, unsigned int xkind_mask) {
    long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= N) return;
    T y = ym[p];
    T x = xm[p];
    if (!live_lane(y, NY)) return;
    const int m = ntaps(order, deriv_type);
    const int iy0 = stencil_i0(y, order, deriv_type);
    const int ix0 = stencil_i0(x, order, deriv_type);
    T wy[2][kMaxTaps], wx[2][kMaxTaps];
    for (int k = 0; k < m; ++k) {
        T uy = y - T(iy0 + k);
        T ux = x - T(ix0 + k);
        wy[0][k] = wfun(uy, order, deriv_type, 0);
        wx[0][k] = wfun(ux, order, deriv_type, 0);
        wy[1][k] = ykind_mask ? wfun(uy, order, deriv_type, 1) : T(0);
        wx[1][k] = xkind_mask ? wfun(ux, order, deriv_type, 1) : T(0);
    }
    const long long plane = (long long)NY * NX;
    for (int c = 0; c < C; ++c) {
        const T v = values[(long long)c * N + p];
        if (v == T(0)) continue;
        const T* cy = wy[(ykind_mask >> c) & 1u];
        const T* cx = wx[(xkind_mask >> c) & 1u];
        T* f = fields + c * plane;
        for (int a = 0; a < m; ++a) {
            const int row = iy0 + a;
            if (row < 0 || row >= NY) continue;
            const T vy = v * cy[a];
            if (vy == T(0)) continue;
            for (int b = 0; b < m; ++b) {
                const int col = ix0 + b;
                if (col < 0 || col >= NX) continue;
                const T w = vy * cx[b];
                if (w != T(0)) atomicAdd(f + (long long)row * NX + col, w);
            }
        }
    }
}

template <typename T>
int launch_deposit(void* fields, const void* ym, const void* xm,
                   const void* values, int C, long long N, int NY, int NX,
                   int order, int deriv_type, unsigned int ykind_mask,
                   unsigned int xkind_mask, void* stream) {
    if (N > 0) {
        const int block = 256;
        const long long grid = (N + block - 1) / block;
        deposit_kernel<T><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
            (T*)fields, (const T*)ym, (const T*)xm, (const T*)values, C, N, NY,
            NX, order, deriv_type, ykind_mask, xkind_mask);
    }
    return (int)cudaGetLastError();
}

}  // namespace hipace

extern "C" {
int hipace_deposit_f32(void* fields, const void* ym, const void* xm,
                       const void* values, int C, long long N, int NY, int NX,
                       int order, int deriv_type, unsigned int ykind_mask,
                       unsigned int xkind_mask, void* stream) {
    return hipace::launch_deposit<float>(fields, ym, xm, values, C, N, NY, NX,
                                         order, deriv_type, ykind_mask,
                                         xkind_mask, stream);
}
int hipace_deposit_f64(void* fields, const void* ym, const void* xm,
                       const void* values, int C, long long N, int NY, int NX,
                       int order, int deriv_type, unsigned int ykind_mask,
                       unsigned int xkind_mask, void* stream) {
    return hipace::launch_deposit<double>(fields, ym, xm, values, C, N, NY, NX,
                                          order, deriv_type, ykind_mask,
                                          xkind_mask, stream);
}
}
