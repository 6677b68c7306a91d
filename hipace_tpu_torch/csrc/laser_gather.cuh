// The laser's |a|^2 and its centred derivatives at one lane (ref
// FieldGather.H:236-280 doLaserGatherShapeN), computed as ops/gather.py
// gather_laser_aabs computes them with PyTorch's ops on the card, rounding
// step by rounding step: the order-P shape weights of the lane's position
// in cells, the (m+2) x (m+2) block of the padded plane around its stencil
// (m = P + 1 taps; rows clamped to the plane, the block's first column
// clamped so that the block fits), and the weighted sums of the block's
// centre and of its centred differences, each summed over the m^2 taps in
// the order of PyTorch's CUDA sum over the last dimension (reduce_sum).
// Used by the fused plasma push (plasma_push.cu) and by the plasma deposit's
// values kernel (deposit_values.cu), which needs only the value.
#pragma once

#include "push_common.cuh"

namespace hipace {

// the leftmost cell of the order-P stencil (ops/shape.py leftmost)
template <int P, typename T>
__device__ __forceinline__ long long leftmost_cell(T x) {
    if constexpr (P == 0 || P == 2) return (long long)floor(add(x, T(0.5))) - P / 2;
    return (long long)floor(x) - (P - 1) / 2;
}

// B_P(u) as ops/shape.py bspline evaluates it on tensors (a division by a
// Python scalar is PyTorch's multiply by its reciprocal)
template <int P, typename T>
__device__ __forceinline__ T bspline_torch(T u) {
    const T au = u < T(0) ? -u : u;
    if constexpr (P == 0) {
        return (u >= T(-0.5) && u < T(0.5)) ? T(1) : T(0);
    } else if constexpr (P == 1) {
        const T v = sub(T(1), au);
        return v < T(0) ? T(0) : v;
    } else if constexpr (P == 2) {
        if (au <= T(0.5)) return sub(T(0.75), mul(au, au));
        const T t = sub(T(1.5), au);
        return au < T(1.5) ? mul(T(0.5), mul(t, t)) : T(0);
    } else {
        static_assert(P == 3, "B-spline orders 0-3");
        const T sixth = quot(T(1), T(6));
        if (au <= T(1))
            return mul(add(sub(T(4), mul(mul(T(6), au), au)), mul(T(3), mul(mul(au, au), au))),
                       sixth);
        const T t = sub(T(2), au);
        return au < T(2) ? mul(mul(mul(t, t), t), sixth) : T(0);
    }
}

// PyTorch's CUDA sum of L values along a contiguous last dimension of
// L < 32 (ATen/native/cuda/Reduce.cuh, one output per row of threads): a row
// of B = last_pow2(L) threads, thread t adding element t and element t + B
// (each into its own accumulator from 0, the accumulators then added with
// the two still at 0), and the threads' values added by warp shuffles at
// offsets B/2, B/4, ..., 1
template <int L, typename T>
__device__ __forceinline__ T torch_row_sum(const T (&e)[L]) {
    static_assert(L >= 1 && L < 32, "a row of at most 31 values");
    constexpr int B = L >= 16 ? 16 : L >= 8 ? 8 : L >= 4 ? 4 : L >= 2 ? 2 : 1;
    T v[B];
#pragma unroll
    for (int t = 0; t < B; ++t) {
        T second = T(0);
        if (t + B < L) second = add(T(0), e[t + B]);
        v[t] = add(add(add(add(T(0), e[t]), second), T(0)), T(0));
    }
#pragma unroll
    for (int off = B / 2; off > 0; off /= 2) {
#pragma unroll
        for (int t = 0; t < off; ++t) v[t] = add(v[t], v[t + off]);
    }
    return v[0];
}

// (a2, a2_dx, a2_dy) of a lane at (xp, yp) from the (NY, NX) |a|^2 plane;
// dx_inv, dy_inv are 1/dx, 1/dy and G the plane's guard cells
template <int P, typename T>
__device__ __forceinline__ void laser_gather(const T* __restrict__ aabs, int NY, int NX, int G,
                                             T xp, T yp, T x_off, T y_off, T dx_inv, T dy_inv,
                                             T& a2, T& a2_dx, T& a2_dy) {
    constexpr int m = P + 1;
    constexpr int mb = m + 2;
    const T xmid = mul(sub(xp, x_off), dx_inv);
    const T ymid = mul(sub(yp, y_off), dy_inv);
    const long long ix0 = leftmost_cell<P>(xmid), iy0 = leftmost_cell<P>(ymid);
    T wx[m], wy[m];
#pragma unroll
    for (int k = 0; k < m; ++k) {
        wx[k] = bspline_torch<P>(sub(xmid, T(ix0 + k)));
        wy[k] = bspline_torch<P>(sub(ymid, T(iy0 + k)));
    }
    long long col = ix0 - 1 + G;
    col = col < 0 ? 0 : col;
    col = col > NX - mb ? NX - mb : col;
    T blk[mb][mb];
#pragma unroll
    for (int a = 0; a < mb; ++a) {
        long long row = iy0 - 1 + G + a;
        row = row < 0 ? 0 : (row > NY - 1 ? NY - 1 : row);
        const T* r = aabs + row * NX + col;
#pragma unroll
        for (int b = 0; b < mb; ++b) blk[a][b] = __ldg(r + b);
    }
    T ev[m * m], ex[m * m], ey[m * m];
#pragma unroll
    for (int a = 0; a < m; ++a) {
#pragma unroll
        for (int b = 0; b < m; ++b) {
            const T w = mul(wy[a], wx[b]);
            const T hw = mul(w, T(0.5));
            ev[a * m + b] = mul(w, blk[a + 1][b + 1]);
            ex[a * m + b] = mul(mul(hw, dx_inv), sub(blk[a + 1][b + 2], blk[a + 1][b]));
            ey[a * m + b] = mul(mul(hw, dy_inv), sub(blk[a + 2][b + 1], blk[a][b + 1]));
        }
    }
    a2 = torch_row_sum(ev);
    a2_dx = torch_row_sum(ex);
    a2_dy = torch_row_sum(ey);
}

}  // namespace hipace
