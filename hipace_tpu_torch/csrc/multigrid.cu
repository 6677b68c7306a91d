// K3: geometric multigrid for Laplacian(u) - acf*u = rhs with Dirichlet
// boundaries, C channels sharing one acf: real (Bx, By; hpmg solve1) or
// complex (the laser envelope; hpmg solve2).
//
// Replaces the TPU kernel _mg_kernel driven by FusedMG.solve
// (hipace_tpu/ops/pallas_mg.py:62-249), held to the XLA path of
// MultiGrid.solve (hipace_tpu/fields/multigrid.py:80-296): red-black
// Gauss-Seidel (red = (ix+iy) even first, nu1/nu2 sweeps, nu1 + 8 on the
// coarsest level), prolongation 2R^T per dimension, exact stencils
// throughout (no reduced-precision transfers). Two template parameters:
//   CC, the grid convention:
//     node-centered (odd sizes, the TPU kernel's only one): zero ghost
//       nodes, a scalar diagonal, full-weighting restriction
//       [1,2,1]/4 x [1,2,1]/4, bilinear prolongation;
//     cell-centered (even sizes, XLA-only in the JAX package): zero at the
//       cell faces, so an edge cell's boundary-facing neighbour weighs 4/3
//       and its diagonal is -4 fac in that dimension (a per-cell diagonal),
//       the 2x2 average as restriction, injection as prolongation;
//   CX, complex values (XLA-only in the JAX package): u, rhs and acf are
//     complex, stored planar (a channel's real plane, then its imaginary
//     plane). The Laplacian and the transfers act on the two planes alike;
//     a cell's smoother update and residual couple them through the complex
//     products (diag - acf) u and (rhs - off) / (diag - acf), with the
//     reciprocal written conj(d) / |d|^2; the max-norm is the modulus
//     (hypot). Each thread holds both parts of its cells.
//
// What bounds it on the H100: bytes, by the roofline (u0, rhs and acf read
// once and u written once take microseconds), but what it really pays is
// the ladder's serial depth: per V-cycle two dependent stages per level,
// each of them dependent half-sweeps. The TPU kernel kept the whole ladder
// in VMEM; a block here has 227 KB of shared memory, so ONE persistent
// cooperative kernel runs the whole solve and its blocks meet at grid
// barriers between stages:
//
//   set-up     copy u0, fill a scalar acf, zero the norm slots | first
//              residual and rhs max-norms -> the stopping threshold
//   V-cycle    down(0) .. down(Lc-1) | coarse | up(Lc-1) .. up(0)
//
// down(l) and up(l) are tile stages. A block loads a 64 x 64 array of u, rhs
// and the diagonal terms, each thread a strip of one column into registers
// and u also into shared memory: its (64 - 2H)^2 cells plus a halo of
// H = 2 max(nu1, nu2) + 2 cells, which covers one cell per colour half-sweep
// plus the reach of the residual and of the restriction. It runs the sweeps
// there, and
//   down: forms the residual, restricts it, writes u and the coarse rhs (and,
//         in the first cycle, the coarsened acf);
//   up:   adds the prolonged coarse correction while loading, sweeps, writes
//         u, and on level 0 takes the residual max-norm for the convergence
//         test.
// The halo is recomputed, not exchanged: red-black Gauss-Seidel gives every
// cell the same operations in the same order as a grid-wide sweep, the cells
// near the array edge just go stale and are never written back. Stages
// ping-pong between two buffers per level, so a block never reads what its
// neighbour writes in the same stage. Every level from Lc down fits one
// block's shared memory and runs there (ref HpMultiGrid.cpp:1073-1096) while
// the other blocks wait at the barrier. The loop
// `while (res > target && it < max_iters)` runs on the device: all blocks read
// the same norm slot after a barrier. Nothing is read back by the host; the
// V-cycle count and the last residual norm go to device scalars.
//
// The smoother and the residual use round-to-nearest intrinsics that nvcc
// never contracts into FMAs, so the tile stages, the single-block stage and
// the plain PyTorch version round alike. The transfers' products are by
// powers of two, exact, so a contraction there rounds as the plain version
// does. The cell-centered levels need a restriction reach of 0 cells, not 1;
// they keep the same even halo, so tile origins stay even. A complex cell
// doubles the registers and the shared memory of a real one.

#include "common.cuh"

#include <cooperative_groups.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace hipace {

constexpr int kMaxLevels = 16;
constexpr int kTileDim = 64;            // tile array, halo included
constexpr int kTileLd = kTileDim + 2;   // plus a ring of zeros

// unsigned integer of a float's width: the bit patterns of non-negative
// floats order like their values, so an integer atomicMax takes the max
template <typename T> struct Bits;
template <> struct Bits<float> { using type = unsigned int; };
template <> struct Bits<double> { using type = unsigned long long; };

__device__ __forceinline__ unsigned int to_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned long long to_bits(double v) {
    return (unsigned long long)__double_as_longlong(v);
}
__device__ __forceinline__ float from_bits(unsigned int b) { return __uint_as_float(b); }
__device__ __forceinline__ double from_bits(unsigned long long b) {
    return __longlong_as_double((long long)b);
}

// products and sums that are never contracted into an FMA
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// ------------------------------------------------------- complex values
template <typename T>
struct Cx {
    T re, im;
};

template <typename T>
__device__ __forceinline__ Cx<T> operator-(Cx<T> a) { return {-a.re, -a.im}; }
template <typename T>
__device__ __forceinline__ Cx<T> add_rn(Cx<T> a, Cx<T> b) {
    return {add_rn(a.re, b.re), add_rn(a.im, b.im)};
}
template <typename T>
__device__ __forceinline__ Cx<T> mul_rn(T s, Cx<T> v) { return {mul_rn(s, v.re), mul_rn(s, v.im)}; }
template <typename T>
__device__ __forceinline__ Cx<T> mul_rn(Cx<T> v, T s) { return {mul_rn(v.re, s), mul_rn(v.im, s)}; }
// (a.re b.re - a.im b.im) + i (a.re b.im + a.im b.re), each product rounded
template <typename T>
__device__ __forceinline__ Cx<T> mul_rn(Cx<T> a, Cx<T> b) {
    return {add_rn(mul_rn(a.re, b.re), -mul_rn(a.im, b.im)),
            add_rn(mul_rn(a.re, b.im), mul_rn(a.im, b.re))};
}
// the transfers' exact products and their sums, free to contract
template <typename T>
__device__ __forceinline__ Cx<T> operator*(T s, Cx<T> v) { return {s * v.re, s * v.im}; }
template <typename T>
__device__ __forceinline__ Cx<T> operator+(Cx<T> a, Cx<T> b) { return {a.re + b.re, a.im + b.im}; }
template <typename T>
__device__ __forceinline__ Cx<T>& operator+=(Cx<T>& a, Cx<T> b) {
    a.re += b.re;
    a.im += b.im;
    return a;
}

// the value type of a cell and its global-memory planes: a complex channel
// is NP = 2 planes of one level, the imaginary one `ps` elements on
template <typename T, bool CX> struct Val;
template <typename T> struct Val<T, false> {
    using V = T;
    static constexpr int NP = 1;
    __device__ static __forceinline__ T ld(const T* p, long long i, long long) { return p[i]; }
    __device__ static __forceinline__ void st(T* p, long long i, long long, T v) { p[i] = v; }
};
template <typename T> struct Val<T, true> {
    using V = Cx<T>;
    static constexpr int NP = 2;
    __device__ static __forceinline__ Cx<T> ld(const T* p, long long i, long long ps) {
        return {p[i], p[i + ps]};
    }
    __device__ static __forceinline__ void st(T* p, long long i, long long ps, Cx<T> v) {
        p[i] = v.re;
        p[i + ps] = v.im;
    }
};

// a read-only view of one channel in global memory, indexable like an array
template <typename T, bool CX>
struct Plane {
    const T* p;
    long long ps;
    __device__ __forceinline__ typename Val<T, CX>::V operator[](long long i) const {
        return Val<T, CX>::ld(p, i, ps);
    }
};

// diag - acf: the imaginary part is -acf.im
template <typename T>
__device__ __forceinline__ T dma_of(T dg, T a) { return dg - a; }
template <typename T>
__device__ __forceinline__ Cx<T> dma_of(T dg, Cx<T> a) { return {dg - a.re, -a.im}; }

// 1 / d: complex as conj(d) / |d|^2
template <typename T>
__device__ __forceinline__ T recip(T d) { return T(1) / d; }
template <typename T>
__device__ __forceinline__ Cx<T> recip(Cx<T> d) {
    const T n = add_rn(mul_rn(d.re, d.re), mul_rn(d.im, d.im));
    return {d.re / n, (-d.im) / n};
}

template <typename T>
__device__ __forceinline__ T absval(T a) { return a < T(0) ? -a : a; }
// the modulus as torch.abs and torch.hypot take it on the card
__device__ __forceinline__ float absval(Cx<float> a) { return hypotf(a.re, a.im); }
__device__ __forceinline__ double absval(Cx<double> a) { return hypot(a.re, a.im); }

template <typename T, bool CX>
struct MgParams {
    const T* u_in;
    // per level: A = the down-leg's u, B = the level's final u (B[0] is the
    // solution), rhs (rhs[0] is the caller's), acf (acf[0] the caller's or
    // scratch for a scalar acf). Entries the solve never touches are null.
    // A complex level holds NP = 2 planes per channel, and acf two planes.
    T* A[kMaxLevels];
    T* B[kMaxLevels];
    T* rhs[kMaxLevels];
    T* acf[kMaxLevels];
    int ny[kMaxLevels];
    int nx[kMaxLevels];
    double facx[kMaxLevels];
    double facy[kMaxLevels];
    double acf_scalar;
    double tol_rel, tol_abs;
    int acf_fill;     // fill acf[0] with acf_scalar (real solves only)
    int C, L, Lc, nu1, nu2, coarse_sweeps, halo, max_iters;
    typename Bits<T>::type* slots;   // max_iters + 2 max-norms
    int* cycles;
    T* resnorm;
};

// facx (uW + uE) + facy (uN + uS)
template <typename T, typename V>
__device__ __forceinline__ V stencil_off(V uW, V uE, V uS, V uN, T facx, T facy) {
    return add_rn(mul_rn(facx, add_rn(uW, uE)), mul_rn(facy, add_rn(uN, uS)));
}

// the Gauss-Seidel update (rhs - off) * invd
template <typename V>
__device__ __forceinline__ V gs_update(V rhs, V off, V invd) {
    return mul_rn(add_rn(rhs, -off), invd);
}

// rhs - (off + dma u)
template <typename V>
__device__ __forceinline__ V residual_at(V rhs, V off, V dma, V u) {
    return add_rn(rhs, -add_rn(off, mul_rn(dma, u)));
}

// the cell-centered weight of a neighbour: 4/3 where the cell's other side
// is the boundary
template <typename T>
__device__ __forceinline__ T cc_coef(bool edge) { return edge ? T(4.0 / 3.0) : T(1); }

// the off-diagonal part at grid cell (iy, ix) of an (ny, nx) level from its
// four neighbours (zero outside the grid): facx (uW + uE) + facy (uN + uS),
// cell-centered facx (uW cW + uE cE) + facy (uS cS + uN cN)
template <typename T, bool CC, typename V>
__device__ __forceinline__ V stencil_at(V uW, V uE, V uS, V uN, int iy, int ix,
                                        int ny, int nx, T facx, T facy) {
    if constexpr (CC) {
        const V w = mul_rn(uW, cc_coef<T>(ix == nx - 1));
        const V e = mul_rn(uE, cc_coef<T>(ix == 0));
        const V so = mul_rn(uS, cc_coef<T>(iy == ny - 1));
        const V no = mul_rn(uN, cc_coef<T>(iy == 0));
        return add_rn(mul_rn(facx, add_rn(w, e)), mul_rn(facy, add_rn(so, no)));
    } else {
        return stencil_off(uW, uE, uS, uN, facx, facy);
    }
}

// the cell-centered diagonal at (iy, ix), summed in double and rounded once,
// as the plain version's float64 plane is
template <typename T>
__device__ __forceinline__ T cc_diag(int iy, int ix, int ny, int nx, double facx,
                                     double facy) {
    const double dx_ = (ix == 0 || ix == nx - 1 ? -4.0 : -2.0) * facx;
    const double dy_ = (iy == 0 || iy == ny - 1 ? -4.0 : -2.0) * facy;
    return T(dx_ + dy_);
}

// the diagonal of the Laplacian at (iy, ix) of level l
template <typename T, bool CC, bool CX>
__device__ __forceinline__ T diag_at(const MgParams<T, CX>& p, int l, int iy, int ix) {
    if constexpr (CC)
        return cc_diag<T>(iy, ix, p.ny[l], p.nx[l], p.facx[l], p.facy[l]);
    else
        return T(-2.0 * (p.facx[l] + p.facy[l]));
}

// the off-diagonal part on a bare (ny, nx) plane with zero Dirichlet ghosts;
// uc is a pointer to values or a Plane view
template <typename T, bool CC, typename V, typename A>
__device__ __forceinline__ V offdiag(A uc, int iy, int ix, int ny, int nx, T facx,
                                     T facy) {
    const int i = iy * nx + ix;
    V uW = ix > 0 ? V(uc[i - 1]) : V{};
    V uE = ix < nx - 1 ? V(uc[i + 1]) : V{};
    V uS = iy > 0 ? V(uc[i - nx]) : V{};
    V uN = iy < ny - 1 ? V(uc[i + nx]) : V{};
    return stencil_at<T, CC>(uW, uE, uS, uN, iy, ix, ny, nx, facx, facy);
}

// restriction of one coarse node (icy, icx) from a fine plane of row stride
// ldf: the separable [1,2,1]/4 stencil, rows first as in Ry r Rx^T
template <typename T, typename E>
__device__ __forceinline__ E restrict_node(const E* fc, int icy, int icx, int ldf) {
    const int jy = 2 * icy + 1, jx = 2 * icx + 1;
    E t[3];
    for (int b = 0; b < 3; ++b) {
        const int col = jx - 1 + b;
        t[b] = T(0.25) * fc[(jy - 1) * ldf + col] + T(0.5) * fc[jy * ldf + col] +
               T(0.25) * fc[(jy + 1) * ldf + col];
    }
    return T(0.25) * t[0] + T(0.5) * t[1] + T(0.25) * t[2];
}

// the cell-centered restriction, the 2x2 average, rows first as in Ry r Rx^T
template <typename T, typename E>
__device__ __forceinline__ E restrict_cc(const E* fc, int icy, int icx, int ldf) {
    const E* r0 = fc + (2 * icy) * ldf + 2 * icx;
    const E* r1 = r0 + ldf;
    const E t0 = T(0.5) * r0[0] + T(0.5) * r1[0];
    const E t1 = T(0.5) * r0[1] + T(0.5) * r1[1];
    return T(0.5) * t0 + T(0.5) * t1;
}

template <typename T, bool CC, typename E>
__device__ __forceinline__ E restrict_at(const E* fc, int icy, int icx, int ldf) {
    if constexpr (CC)
        return restrict_cc<T>(fc, icy, icx, ldf);
    else
        return restrict_node<T>(fc, icy, icx, ldf);
}

// bilinear prolongation of a coarse plane at fine node (jy, jx)
template <typename T, typename V>
__device__ __forceinline__ V prolong_node(const V* cc, int jy, int jx, int nyc,
                                          int nxc) {
    int iy[2], ix[2];
    T wy[2], wx[2];
    int ny_ = 0, nx_ = 0;
    if (jy & 1) {
        iy[ny_] = (jy - 1) / 2; wy[ny_++] = T(1);
    } else {
        if (jy / 2 - 1 >= 0) { iy[ny_] = jy / 2 - 1; wy[ny_++] = T(0.5); }
        if (jy / 2 < nyc) { iy[ny_] = jy / 2; wy[ny_++] = T(0.5); }
    }
    if (jx & 1) {
        ix[nx_] = (jx - 1) / 2; wx[nx_++] = T(1);
    } else {
        if (jx / 2 - 1 >= 0) { ix[nx_] = jx / 2 - 1; wx[nx_++] = T(0.5); }
        if (jx / 2 < nxc) { ix[nx_] = jx / 2; wx[nx_++] = T(0.5); }
    }
    V v{};
    for (int a = 0; a < ny_; ++a) {
        V t{};
        for (int b = 0; b < nx_; ++b) t += wx[b] * cc[iy[a] * nxc + ix[b]];
        v += wy[a] * t;
    }
    return v;
}

// the same prolongation from a coarse tile of row stride ld that holds zeros
// outside the grid, at tile-local fine node (jy, jx) with jy, jx >= 1: the
// terms prolong_node leaves out at the grid's edge are zeros here, and a
// product with 0.5 is exact, so both give the same value
template <typename T, typename V>
__device__ __forceinline__ V prolong_tile(const V* sc, int jy, int jx, int ld) {
    const V* lo = sc + ((jy - 1) >> 1) * ld;
    const V* hi = sc + (jy >> 1) * ld;
    const int xlo = (jx - 1) >> 1, xhi = jx >> 1;
    const bool xodd = jx & 1;
    const V tlo = xodd ? lo[xlo] : T(0.5) * lo[xlo] + T(0.5) * lo[xhi];
    if (jy & 1) return tlo;
    const V thi = xodd ? hi[xlo] : T(0.5) * hi[xlo] + T(0.5) * hi[xhi];
    return T(0.5) * tlo + T(0.5) * thi;
}

// NaN-propagating max of non-negative values
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) { return (b > a || b != b) ? b : a; }

// block-wide nanmax folded into *slot; every thread of the block calls it
template <typename T>
__device__ void block_max_to_slot(T m, typename Bits<T>::type* slot) {
    __shared__ T part[32];
    for (int o = 16; o > 0; o >>= 1) m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, o));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) part[warp] = m;
    __syncthreads();
    if (warp == 0) {
        const int nwarps = blockDim.x >> 5;
        m = lane < nwarps ? part[lane] : T(0);
        for (int o = 16; o > 0; o >>= 1)
            m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, o));
        if (lane == 0) atomicMax(slot, to_bits(m));
    }
    __syncthreads();
}

// Python's max(a, b): b only if it compares greater
__device__ __forceinline__ double pymax(double a, double b) { return b > a ? b : a; }

// ------------------------------------------------------------- tile stages
// One fine level's down-leg (sweeps, residual, restriction) or up-leg
// (prolong-add, sweeps, on level 0 the residual max-norm into *slot).
// Cell-centered, the diagonal and the neighbour weights are worked out per
// cell from its grid position.
//
// A thread owns one column of R = 64 * 64 / THREADS consecutive rows of the
// tile array and keeps their u, rhs, dma and invd in registers; a warp is 32
// neighbouring columns of one strip of rows. Shared memory holds a copy of u
// (inside a ring of zeros) for the neighbours of other threads, and a second
// array for the residual that the restriction reads, or for the coarse tile
// that the prolongation reads. A half-sweep costs a thread two shared loads
// per updated cell, not seven.
template <typename T, bool CC, bool CX, int THREADS>
__device__ void tile_stage(const MgParams<T, CX>& p, T* sm, int l, bool down, bool first,
                           typename Bits<T>::type* slot) {
    using IO = Val<T, CX>;
    using V = typename IO::V;
    constexpr int NP = IO::NP;
    constexpr int AD = kTileDim, LD = kTileLd;
    constexpr int R = AD * AD / THREADS;      // rows per thread, even
    constexpr int LDC = AD / 2 + 2;           // coarse tile: 33 rows and columns
    const int H = p.halo, TS = AD - 2 * H, TC = TS / 2;
    const int ny = p.ny[l], nx = p.nx[l], nyc = p.ny[l + 1], nxc = p.nx[l + 1];
    const int nty = (ny + TS - 1) / TS, ntx = (nx + TS - 1) / TS;
    const int items = p.C * nty * ntx;
    const T fx = T(p.facx[l]), fy = T(p.facy[l]);
    const T diag = T(-2.0 * (p.facx[l] + p.facy[l]));
    const long long plane = (long long)ny * nx, planec = (long long)nyc * nxc;
    V* su = reinterpret_cast<V*>(sm);
    V* sr = su + LD * LD;
    const T* src_u = down ? (l == 0 ? p.B[0] : nullptr) : p.A[l];
    T* dst_u = down ? p.A[l] : p.B[l];
    const T* acf = p.acf[l];
    const int b = threadIdx.x % AD, a0 = (threadIdx.x / AD) * R;
    const int sweeps = down ? p.nu1 : p.nu2;
    const bool want_norm = !down && l == 0;
    T m = T(0);
    // the ring around u stays zero; the single-block stage may have used it
    for (int i = threadIdx.x; i < LD; i += THREADS) {
        su[i] = su[(LD - 1) * LD + i] = V{};
        su[i * LD] = su[i * LD + LD - 1] = V{};
    }

    for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int c = item / (nty * ntx), t = item % (nty * ntx);
        const int fy0 = (t / ntx) * TS, fx0 = (t % ntx) * TS;
        // array cell (a, b) is grid cell (gy0 + a, gx0 + b); both even
        const int gy0 = fy0 - H, gx0 = fx0 - H;
        const T* rhs_c = p.rhs[l] + c * NP * plane;
        const int gx = gx0 + b;
        const bool col_in = gx >= 0 && gx < nx;
        const int gxc = min(max(gx, 0), nx - 1);

        if (!down) {
            // the coarse cells under this array, zeros outside the grid:
            // coarse (cy0 + i, cx0 + j) at sr[i * LDC + j]
            const int cy0 = gy0 / 2 - 1, cx0 = gx0 / 2 - 1;
            const T* cu = p.B[l + 1] + c * NP * planec;
            for (int i = threadIdx.x; i < (LDC - 1) * (LDC - 1); i += THREADS) {
                const int iy = i / (LDC - 1), ix = i % (LDC - 1);
                const int cy = cy0 + iy, cx = cx0 + ix;
                const bool in = cy >= 0 && cy < nyc && cx >= 0 && cx < nxc;
                sr[iy * LDC + ix] = in ? IO::ld(cu, (long long)cy * nxc + cx, planec) : V{};
            }
            __syncthreads();
        }

        // this thread's column strip into registers: every load goes
        // to a clamped address, ghosts are zeroed afterwards
        V u[R], r[R], d[R], iv[R];
        unsigned int inmask = 0;
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const int gy = gy0 + a0 + j;
            const bool in = col_in && gy >= 0 && gy < ny;
            const int gyc = min(max(gy, 0), ny - 1);
            const long long g = (long long)gyc * nx + gxc;
            const V rv = IO::ld(rhs_c, g, plane);
            T dg = diag;
            if constexpr (CC) dg = cc_diag<T>(gyc, gxc, ny, nx, p.facx[l], p.facy[l]);
            const V dv = dma_of(dg, IO::ld(acf, g, plane));
            const V uv = src_u ? IO::ld(src_u + c * NP * plane, g, plane) : V{};
            inmask |= (in ? 1u : 0u) << j;
            r[j] = in ? rv : V{};
            d[j] = in ? dv : V{};
            iv[j] = in ? recip(dv) : V{};
            u[j] = in ? uv : V{};
        }
        if (!down) {
#pragma unroll
            for (int j = 0; j < R; ++j)
                if ((inmask >> j) & 1u) {
                    if constexpr (CC)   // injection: coarse cell gy / 2
                        u[j] += sr[((a0 + j) / 2 + 1) * LDC + b / 2 + 1];
                    else
                        u[j] += prolong_tile<T>(sr, a0 + j + 2, b + 2, LDC);
                }
        }
#pragma unroll
        for (int j = 0; j < R; ++j) su[(a0 + j + 1) * LD + b + 1] = u[j];
        __syncthreads();

        for (int s = 0; s < 2 * sweeps; ++s) {
            // a0, gy0 and gx0 are even: the rows of colour s & 1 in this
            // column are a0 + 2k + par
            const int par = (b + s) & 1;
#pragma unroll
            for (int k = 0; k < R / 2; ++k) {
                const int j = 2 * k + par;
                const int i = (a0 + j + 1) * LD + b + 1;
                if ((inmask >> j) & 1u) {
                    const V uS = par ? u[2 * k] : (k > 0 ? u[2 * k - 1] : su[i - LD]);
                    const V uN = par ? (k < R / 2 - 1 ? u[2 * k + 2] : su[i + LD])
                                     : u[2 * k + 1];
                    const V off = stencil_at<T, CC>(su[i - 1], su[i + 1], uS, uN,
                                                    gy0 + a0 + j, gx, ny, nx, fx, fy);
                    const V nu = gs_update(par ? r[2 * k + 1] : r[2 * k], off,
                                           par ? iv[2 * k + 1] : iv[2 * k]);
                    if (par) u[2 * k + 1] = nu; else u[2 * k] = nu;
                    su[i] = nu;
                }
            }
            __syncthreads();
        }

        if (down || want_norm) {
            // the residual: to shared memory for the restriction, or into
            // the max-norm over the block's own cells
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const int a = a0 + j;
                const int i = (a + 1) * LD + b + 1;
                const V uS = j > 0 ? u[j - 1] : su[i - LD];
                const V uN = j < R - 1 ? u[j + 1] : su[i + LD];
                const V off = stencil_at<T, CC>(su[i - 1], su[i + 1], uS, uN,
                                                gy0 + a, gx, ny, nx, fx, fy);
                const V res = ((inmask >> j) & 1u)
                                  ? residual_at(r[j], off, d[j], u[j]) : V{};
                if (down)
                    sr[i] = res;
                else if (a >= H && a < H + TS && b >= H && b < H + TS)
                    m = nanmax(m, absval(res));
            }
        }
        if (down) {
            __syncthreads();
            const int cy0 = fy0 / 2, cx0 = fx0 / 2;
            const V* res0 = sr + (H + 1) * LD + (H + 1);   // grid cell (fy0, fx0)
            T* rhs_n = p.rhs[l + 1] + c * NP * planec;
            for (int i = threadIdx.x; i < TC * TC; i += THREADS) {
                const int lcy = i / TC, lcx = i % TC;
                const int icy = cy0 + lcy, icx = cx0 + lcx;
                if (icy < nyc && icx < nxc) {
                    const long long ic = (long long)icy * nxc + icx;
                    IO::st(rhs_n, ic, planec, restrict_at<T, CC>(res0, lcy, lcx, LD));
                    if (first && c == 0)
                        for (int q = 0; q < NP; ++q)   // each plane of acf
                            p.acf[l + 1][q * planec + ic] =
                                restrict_at<T, CC>(acf + q * plane, icy, icx, nx);
                }
            }
        }

        // write the block's own cells
        if (b >= H && b < H + TS) {
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const int a = a0 + j;
                if (a >= H && a < H + TS && ((inmask >> j) & 1u))
                    IO::st(dst_u + c * NP * plane, (long long)(gy0 + a) * nx + gx,
                           plane, u[j]);
            }
        }
        __syncthreads();
    }
    if (want_norm) block_max_to_slot(m, slot);
}

// ------------------------------------------------------ single-block stage
template <typename T, bool CC, typename V>
__device__ void block_smooth(V* u, const V* rhs, const V* invd, int C, int ny,
                             int nx, T facx, T facy, int sweeps) {
    const int n = C * ny * nx;
    for (int s = 0; s < 2 * sweeps; ++s) {
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int ix = i % nx, iy = (i / nx) % ny;
            if (((ix + iy) & 1) != (s & 1)) continue;
            const int base = i - (iy * nx + ix);
            const V off = offdiag<T, CC, V>(u + base, iy, ix, ny, nx, facx, facy);
            u[i] = gs_update(rhs[i], off, invd[iy * nx + ix]);
        }
        __syncthreads();
    }
}

// The levels Lc .. L-1 of one V-cycle in one block, every level in shared
// memory. Level Lc's rhs comes from global memory; its u is the running
// solution when Lc = 0 (then the residual max-norm goes to *slot) and zero
// otherwise.
template <typename T, bool CC, bool CX>
__device__ void coarse_stage(const MgParams<T, CX>& p, T* sm,
                             typename Bits<T>::type* slot) {
    using IO = Val<T, CX>;
    using V = typename IO::V;
    constexpr int NP = IO::NP;
    const int C = p.C, L0 = p.Lc, L = p.L;
    V* us[kMaxLevels];
    V* rs[kMaxLevels];
    V* ds[kMaxLevels];
    V* is[kMaxLevels];
    V* ptr = reinterpret_cast<V*>(sm);
    for (int l = L0; l < L; ++l) {
        const int n = p.ny[l] * p.nx[l];
        us[l] = ptr; ptr += C * n;
        rs[l] = ptr; ptr += C * n;
        ds[l] = ptr; ptr += n;
        is[l] = ptr; ptr += n;
    }
    V* res = ptr;
    const int n0 = p.ny[L0] * p.nx[L0];
    // acf down the ladder (held in ds), then dma = diag - acf and 1 / dma
    for (int i = threadIdx.x; i < n0; i += blockDim.x) ds[L0][i] = IO::ld(p.acf[L0], i, n0);
    __syncthreads();
    for (int l = L0; l < L - 1; ++l) {
        const int nyc = p.ny[l + 1], nxc = p.nx[l + 1];
        for (int i = threadIdx.x; i < nyc * nxc; i += blockDim.x)
            ds[l + 1][i] = restrict_at<T, CC>(ds[l], i / nxc, i % nxc, p.nx[l]);
        __syncthreads();
    }
    for (int l = L0; l < L; ++l) {
        const int n = p.ny[l] * p.nx[l];
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const V d = dma_of(diag_at<T, CC>(p, l, i / p.nx[l], i % p.nx[l]), ds[l][i]);
            ds[l][i] = d;
            is[l][i] = recip(d);
        }
    }
    for (int i = threadIdx.x; i < C * n0; i += blockDim.x) {
        const long long g = (long long)(i / n0) * NP * n0 + i % n0;
        us[L0][i] = L0 == 0 ? IO::ld(p.B[0], g, n0) : V{};
        rs[L0][i] = IO::ld(p.rhs[L0], g, n0);
    }
    __syncthreads();
    for (int l = L0; l < L - 1; ++l) {
        const int ny = p.ny[l], nx = p.nx[l];
        const T fx = T(p.facx[l]), fy = T(p.facy[l]);
        block_smooth<T, CC>(us[l], rs[l], is[l], C, ny, nx, fx, fy, p.nu1);
        const int n = C * ny * nx;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int ix = i % nx, iy = (i / nx) % ny;
            const int base = i - (iy * nx + ix);
            const V off = offdiag<T, CC, V>(us[l] + base, iy, ix, ny, nx, fx, fy);
            res[i] = residual_at(rs[l][i], off, ds[l][iy * nx + ix], us[l][i]);
        }
        __syncthreads();
        const int nyc = p.ny[l + 1], nxc = p.nx[l + 1];
        const int nc = C * nyc * nxc;
        for (int i = threadIdx.x; i < nc; i += blockDim.x) {
            const int icx = i % nxc, icy = (i / nxc) % nyc, c = i / (nyc * nxc);
            rs[l + 1][i] = restrict_at<T, CC>(res + c * ny * nx, icy, icx, nx);
            us[l + 1][i] = V{};
        }
        __syncthreads();
    }
    block_smooth<T, CC>(us[L - 1], rs[L - 1], is[L - 1], C, p.ny[L - 1], p.nx[L - 1],
                        T(p.facx[L - 1]), T(p.facy[L - 1]), p.nu1 + p.coarse_sweeps);
    for (int l = L - 2; l >= L0; --l) {
        const int ny = p.ny[l], nx = p.nx[l];
        const int nyc = p.ny[l + 1], nxc = p.nx[l + 1];
        const int n = C * ny * nx;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int jx = i % nx, jy = (i / nx) % ny, c = i / (ny * nx);
            const V* cc = us[l + 1] + c * nyc * nxc;
            if constexpr (CC)
                us[l][i] += cc[(jy / 2) * nxc + jx / 2];
            else
                us[l][i] += prolong_node<T>(cc, jy, jx, nyc, nxc);
        }
        __syncthreads();
        block_smooth<T, CC>(us[l], rs[l], is[l], C, ny, nx, T(p.facx[l]), T(p.facy[l]),
                            p.nu2);
    }
    T m = T(0);
    const int ny = p.ny[L0], nx = p.nx[L0];
    for (int i = threadIdx.x; i < C * n0; i += blockDim.x) {
        const long long g = (long long)(i / n0) * NP * n0 + i % n0;
        IO::st(p.B[L0], g, n0, us[L0][i]);
        if (L0 == 0) {
            const int ix = i % nx, iy = (i / nx) % ny;
            const int base = i - (iy * nx + ix);
            const V off = offdiag<T, CC, V>(us[0] + base, iy, ix, ny, nx,
                                            T(p.facx[0]), T(p.facy[0]));
            m = nanmax(m, absval(residual_at(rs[0][i], off, ds[0][iy * nx + ix],
                                             us[0][i])));
        }
    }
    if (L0 == 0) block_max_to_slot(m, slot);
    __syncthreads();
}

// ------------------------------------------------------------ the solve
template <typename T, bool CC, bool CX, int THREADS>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
mg_solve_kernel(const MgParams<T, CX> p) {
    using IO = Val<T, CX>;
    using V = typename IO::V;
    constexpr int NP = IO::NP;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sm = reinterpret_cast<T*>(smem_raw);
    cg::grid_group grid = cg::this_grid();
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nthreads = (long long)gridDim.x * blockDim.x;
    const int ny = p.ny[0], nx = p.nx[0];
    const long long plane = (long long)ny * nx, n = p.C * plane;

    // set-up: the running solution, a scalar acf as a plane, clean slots
    for (long long i = tid; i < NP * n; i += nthreads) p.B[0][i] = p.u_in[i];
    if constexpr (!CX)   // a complex acf always comes as planes
        if (p.acf_fill)
            for (long long i = tid; i < plane; i += nthreads) p.acf[0][i] = T(p.acf_scalar);
    for (long long i = tid; i < p.max_iters + 2; i += nthreads) p.slots[i] = 0;
    grid.sync();

    // first residual and rhs max-norms
    {
        const T fx = T(p.facx[0]), fy = T(p.facy[0]);
        T mres = T(0), mrhs = T(0);
        for (long long i = tid; i < n; i += nthreads) {
            const int ix = int(i % nx), iy = int((i / nx) % ny);
            const long long cell = (long long)iy * nx + ix;
            const long long base = (i / plane) * NP * plane;
            const Plane<T, CX> uc{p.B[0] + base, plane};
            const V off = offdiag<T, CC, V>(uc, iy, ix, ny, nx, fx, fy);
            const V r = IO::ld(p.rhs[0] + base, cell, plane);
            const V dma = dma_of(diag_at<T, CC>(p, 0, iy, ix), IO::ld(p.acf[0], cell, plane));
            mres = nanmax(mres, absval(residual_at(r, off, dma, uc[cell])));
            mrhs = nanmax(mrhs, absval(r));
        }
        block_max_to_slot(mres, p.slots);
        block_max_to_slot(mrhs, p.slots + 1);
    }
    grid.sync();

    // hpmg's stopping threshold, rounded to the working type
    T res = from_bits(p.slots[0]);
    const T target = T(pymax(p.tol_abs, pymax(p.tol_rel, 1e-16) *
                                            pymax(double(res),
                                                  double(from_bits(p.slots[1])))));
    int it = 0;
    while (res > target && it < p.max_iters) {
        typename Bits<T>::type* slot = p.slots + 2 + it;
        for (int l = 0; l < p.Lc; ++l) {
            tile_stage<T, CC, CX, THREADS>(p, sm, l, true, it == 0, slot);
            grid.sync();
        }
        if (blockIdx.x == 0) coarse_stage<T, CC, CX>(p, sm, slot);
        grid.sync();
        for (int l = p.Lc - 1; l >= 0; --l) {
            tile_stage<T, CC, CX, THREADS>(p, sm, l, false, false, slot);
            grid.sync();
        }
        res = from_bits(p.slots[2 + it]);
        ++it;
    }
    if (tid == 0) {
        *p.cycles = it;
        *p.resnorm = res;
    }
}

// One cooperative launch: as many blocks as the card keeps resident.
template <typename T, bool CC, bool CX, int THREADS>
int launch_solve(const MgParams<T, CX>& p, int smem_bytes, void* stream) {
    auto kernel = mg_solve_kernel<T, CC, CX, THREADS>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess)
        return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, THREADS, smem_bytes)) != cudaSuccess)
        return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {(void*)&p};
    err = cudaLaunchCooperativeKernel((void*)kernel, dim3(per_sm * sms),
                                      dim3(THREADS), args, smem_bytes,
                                      (cudaStream_t)stream);
    return (int)err;
}

// table: 4 rows (A, B, rhs, acf) of L device pointers
template <typename T, bool CX, int THREADS>
int solve_as(const void* u_in, const unsigned long long* table, const int* ny,
             const int* nx, const double* facx, const double* facy, int C, int L,
             int Lc, int nu1, int nu2, int coarse_sweeps, int halo, int max_iters,
             double tol_rel, double tol_abs, int acf_fill, double acf_scalar,
             int cell_centered, void* slots, void* cycles, void* resnorm,
             int smem_bytes, void* stream) {
    MgParams<T, CX> p = {};
    p.u_in = (const T*)u_in;
    for (int l = 0; l < L; ++l) {
        p.A[l] = (T*)table[l];
        p.B[l] = (T*)table[L + l];
        p.rhs[l] = (T*)table[2 * L + l];
        p.acf[l] = (T*)table[3 * L + l];
        p.ny[l] = ny[l];
        p.nx[l] = nx[l];
        p.facx[l] = facx[l];
        p.facy[l] = facy[l];
    }
    p.acf_scalar = acf_scalar;
    p.tol_rel = tol_rel;
    p.tol_abs = tol_abs;
    p.acf_fill = acf_fill;
    p.C = C; p.L = L; p.Lc = Lc; p.nu1 = nu1; p.nu2 = nu2;
    p.coarse_sweeps = coarse_sweeps; p.halo = halo; p.max_iters = max_iters;
    p.slots = (typename Bits<T>::type*)slots;
    p.cycles = (int*)cycles;
    p.resnorm = (T*)resnorm;
    return cell_centered ? launch_solve<T, true, CX, THREADS>(p, smem_bytes, stream)
                         : launch_solve<T, false, CX, THREADS>(p, smem_bytes, stream);
}

template <typename T, int THREADS>
int solve(const void* u_in, const unsigned long long* table, const int* ny,
          const int* nx, const double* facx, const double* facy, int C, int L,
          int Lc, int nu1, int nu2, int coarse_sweeps, int halo, int max_iters,
          double tol_rel, double tol_abs, int acf_fill, double acf_scalar,
          int cell_centered, int cplx, void* slots, void* cycles, void* resnorm,
          int smem_bytes, void* stream) {
    if (L < 1 || L > kMaxLevels || Lc < 0 || Lc >= L || halo < 0 ||
        2 * halo >= kTileDim || max_iters < 0)
        return (int)cudaErrorInvalidValue;
    return cplx ? solve_as<T, true, THREADS>(
                      u_in, table, ny, nx, facx, facy, C, L, Lc, nu1, nu2,
                      coarse_sweeps, halo, max_iters, tol_rel, tol_abs, acf_fill,
                      acf_scalar, cell_centered, slots, cycles, resnorm,
                      smem_bytes, stream)
                : solve_as<T, false, THREADS>(
                      u_in, table, ny, nx, facx, facy, C, L, Lc, nu1, nu2,
                      coarse_sweeps, halo, max_iters, tol_rel, tol_abs, acf_fill,
                      acf_scalar, cell_centered, slots, cycles, resnorm,
                      smem_bytes, stream);
}

}  // namespace hipace

// float: two blocks of 512 threads per SM; double: one block of 1024
#define HIPACE_MG_EXPORT(T, THREADS, SUF)                                         \
    int hipace_mg_solve_##SUF(                                                    \
        const void* u_in, const void* table, const void* ny, const void* nx,      \
        const void* facx, const void* facy, int C, int L, int Lc, int nu1,        \
        int nu2, int coarse_sweeps, int halo, int max_iters, double tol_rel,      \
        double tol_abs, int acf_fill, double acf_scalar, int cell_centered,       \
        int cplx, void* slots, void* cycles, void* resnorm, int smem_bytes,       \
        void* stream) {                                                           \
        return hipace::solve<T, THREADS>(                                         \
            u_in, (const unsigned long long*)table, (const int*)ny,               \
            (const int*)nx, (const double*)facx, (const double*)facy, C, L, Lc,   \
            nu1, nu2, coarse_sweeps, halo, max_iters, tol_rel, tol_abs, acf_fill, \
            acf_scalar, cell_centered, cplx, slots, cycles, resnorm, smem_bytes,  \
            stream);                                                              \
    }

extern "C" {
HIPACE_MG_EXPORT(float, 512, f32)
HIPACE_MG_EXPORT(double, 1024, f64)
}
