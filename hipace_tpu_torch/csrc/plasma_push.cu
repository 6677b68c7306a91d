// Fused plasma push: one plasma species' leapfrog push on one slice, every
// subcycle, in one launch (ref PlasmaParticleAdvance.cpp:29-217 with the
// leapfrog, no active mesh-refinement level). Per lane and subcycle: K2's
// gather of the five planes at the lane's previous position (gather.cuh),
// with a laser the |a|^2 value and its centred derivatives there
// (laser_gather.cuh), the scalings of the gathered values, four second-order
// substeps of the momentum from the half step (the momentum derivative and
// its directional derivative, the dual-number push), the position push, the
// transverse particle boundary (Periodic, Reflecting, Absorbing), the
// half-step write, and two further substeps that give the deposit's values.
// The predictor-corrector's trial push (temp_slice) keeps the half-step
// state and writes only x, y, ux, uy, psi, w and valid. An ionizable
// species' lanes scale q/(mc) by their ion level and the laser's factor by
// its square. The plain version is plasma_push_plain in
// hipace_tpu_torch/ops/plasma_push.py (the port's push loop, which keeps the
// AB5 pusher and the slices with an active fine level), and this kernel
// computes what that loop computes on the card, lane by lane.
//
// Replaces the JAX package's push loop of advance_plasma
// (hipace_tpu/particles/plasma.py:619) on XLA and its K2 plasma call
// (pallas_gather_main, hipace_tpu/ops/pallas_banded.py:663); it replaces no
// Pallas kernel of its own. On the card that loop was ~650 PyTorch
// elementwise launches per species and slice, each reading and writing whole
// lane arrays: ~52 GB per slice of 4.19M float64 lanes, ~18 ms.
//
// What bounds it on the H100: bytes. Each lane reads seven attributes
// (x_prev, y_prev, the three half-step momenta, w, valid: 49 B in float64)
// and writes nine and valid (73 B; eight, 64 B, where the boundary does not
// absorb), and the five field planes (and with a laser the |a|^2 plane) are
// read once: at 2047^2 with 4,190,209 lanes 511 MB of lanes and 168 MB of
// planes (34 MB more with the laser), ~0.68 GB or 0.20 ms at 3.35 TB/s.
// Its ~880 operations per lane (~1,090 with the laser: six substeps of 83
// and 93, K2's gather ~360 at order 2, the |a|^2 gather ~150) come to 3.7
// and 4.6 GFLOP per call, 0.11 and 0.13 ms at 34 TFLOP/s in float64. It
// takes 0.36 ms (0.55 with the laser) on an H100 at 700 W.
//
// Design: one thread per lane, the lane's state in registers through every
// subcycle, as in the fused beam push (beam_push.cu): the lanes share
// nothing but the planes, which stay fixed during the push. The order and
// the laser are template parameters (at order 2 in float64 134 registers
// with the laser's gather and terms, 128 without); the boundary, the ion
// levels and the trial push are flags uniform over the launch. Every rounding step is written with the _rn
// intrinsics in the plain loop's order, and each scalar enters in the
// working type as PyTorch's ops take the loop's Python floats (computed on
// the host, as the loop's scalars are), so that the results are the plain
// loop's bit for bit; the gathers are K2's own code and the plain laser
// gather's order of sums (laser_gather.cuh). Lanes in init order (the
// plasma's lattice) read their neighbours' cells, which L1 and L2 serve.

#include "gather.cuh"
#include "laser_gather.cuh"
#include "push_common.cuh"

#include <climits>

namespace hipace {

constexpr int kPlasmaBlock = 128;   // lanes per block
constexpr int kPlasmaIn = 6;        // x_prev, y_prev, ux_half, uy_half, psi_half, w
// x, y, ux, uy, psi, ux_half, uy_half, psi_half, w (null where not written)
constexpr int kPlasmaOut = 9;

// the push's scalars, as the plain loop's Python floats (the order of
// PARAMS in ops/plasma_push.py)
struct PlasmaParams {
    double dz_ci;                  // dz / c (dz of one subcycle)
    double sdz;                    // dz / 4, one substep
    double half_sdz2;              // 0.5 sdz^2
    double ci, c2, clight;         // 1/c, 1/c^2, c
    double qmc, qmc_ci, qmc_c2;    // q/(mc), and times 1/c and 1/c^2
    double lnorm;                  // the laser's factor ((q/e)(m_e/m))^2
    double lo0, lo1, hi0, hi1;     // the boundary's box
    double lx, ly, two_lx, two_ly; // its widths, and twice them
    double x_off, y_off;           // the grid's position offsets
    double inv_dx_pos, inv_dy_pos; // 1/dx, 1/dy in the working type
    double guards;                 // guard cells
    double inv_dx, inv_dy;         // 1/dx, 1/dy in double
};
constexpr int kPlasmaParams = sizeof(PlasmaParams) / sizeof(double);

// the lane's charge-dependent factors (ionizable species: per lane)
template <typename T>
struct Charge {
    T qmc, qmc_ci, qmc_c2, lnorm;
};

// the gathered values at a lane, scaled as the loop scales them
template <typename T>
struct LaneFields {
    T exmby, eypbx, ez, bx_c, by_c, bz;
    T l0, l1, l2;   // the laser's terms (LASER only)
};

// one substep (plasma._second_order_substep): the momentum derivative
// (_momentum_derivative), its directional derivative along itself
// (_momentum_derivative_jvp), and the second-order update
template <bool LASER, typename T>
__device__ __forceinline__ void substep(T& ux, T& uy, T& psi, const LaneFields<T>& f,
                                        const Charge<T>& q, T ci, T c2, T sdz, T half) {
    const T pi = quot(T(1), psi);
    const T hpi2 = mul(mul(T(0.5), pi), pi);
    // d: PlasmaMomentumPush
    T s1 = LASER ? add(f.l0, T(1)) : T(1);
    s1 = add(s1, mul(mul(mul(ux, ux), ci), ci));
    s1 = add(s1, mul(mul(mul(uy, uy), ci), ci));
    const T gamma_psi = add(mul(hpi2, s1), T(0.5));
    T d0 = mul(q.qmc, add(add(mul(gamma_psi, f.exmby), f.by_c), mul(mul(uy, f.bz), pi)));
    T d1 = mul(q.qmc, sub(sub(mul(gamma_psi, f.eypbx), f.bx_c), mul(mul(ux, f.bz), pi)));
    if (LASER) {
        d0 = sub(d0, mul(f.l1, pi));
        d1 = sub(d1, mul(f.l2, pi));
    }
    const T uxe = mul(ux, f.exmby), uye = mul(uy, f.eypbx);
    const T d2 = mul(q.qmc_ci, sub(mul(mul(add(uxe, uye), ci), pi), f.ez));
    // e: the dual part along (d0, d1, d2)
    const T dpi = mul(mul(-pi, pi), d2);
    T s = LASER ? add(f.l0, T(1)) : T(1);
    s = add(s, mul(mul(ux, ux), c2));
    s = add(s, mul(mul(uy, uy), c2));
    const T ds = mul(mul(T(2), add(mul(ux, d0), mul(uy, d1))), c2);
    const T dgamma = add(mul(mul(pi, dpi), s), mul(hpi2, ds));
    T e0 = mul(q.qmc, add(mul(dgamma, f.exmby), mul(f.bz, add(mul(d1, pi), mul(uy, dpi)))));
    T e1 = mul(q.qmc, sub(mul(dgamma, f.eypbx), mul(f.bz, add(mul(d0, pi), mul(ux, dpi)))));
    if (LASER) {
        e0 = sub(e0, mul(f.l1, dpi));
        e1 = sub(e1, mul(f.l2, dpi));
    }
    const T e2 = mul(q.qmc_c2, add(mul(add(mul(d0, f.exmby), mul(d1, f.eypbx)), pi),
                                   mul(add(uxe, uye), dpi)));
    ux = add(add(ux, mul(sdz, d0)), mul(half, e0));
    uy = add(add(uy, mul(sdz, d1)), mul(half, e1));
    psi = add(add(psi, mul(sdz, d2)), mul(half, e2));
}

template <typename T>
struct PlasmaLanes {
    const T* f[kPlasmaIn];
    const bool* valid;
    const int* ion_lev;       // null where the species does not ionize
};

template <typename T>
struct PlasmaOut {
    T* f[kPlasmaOut];
    bool* valid;              // null where the boundary does not absorb
};

template <int P, bool LASER, typename T>
__global__ void __launch_bounds__(kPlasmaBlock)
plasma_push_kernel(const PlasmaOut<T> out, const PlasmaLanes<T> in, const Planes<T> pl,
                   const T* __restrict__ aabs, const PlasmaParams prm, long long N, int NY,
                   int NX, int n_sub, int boundary, int temp_slice) {
    const long long p = (long long)blockIdx.x * kPlasmaBlock + threadIdx.x;
    if (p >= N) return;
    T xp = in.f[0][p], yp = in.f[1][p];
    T uxh = in.f[2][p], uyh = in.f[3][p], psih = in.f[4][p], w = in.f[5][p];
    bool valid = in.valid[p];

    const T ci = T(prm.ci), c2 = T(prm.c2), clight = T(prm.clight);
    const T sdz = T(prm.sdz), half = T(prm.half_sdz2), dz_ci = T(prm.dz_ci);
    const Box<T> box{T(prm.lo0), T(prm.lo1), T(prm.hi0), T(prm.hi1),
                     T(prm.lx), T(prm.ly), T(prm.two_lx), T(prm.two_ly)};
    const T x_off = T(prm.x_off), y_off = T(prm.y_off);
    const T inv_dx_pos = T(prm.inv_dx_pos), inv_dy_pos = T(prm.inv_dy_pos);
    const T guards = T(prm.guards);
    const T inv_dx = T(prm.inv_dx), inv_dy = T(prm.inv_dy);
    Charge<T> q;
    if (in.ion_lev != nullptr) {
        // each lane's charge is its level times the species' (R16)
        const T ion = T(in.ion_lev[p]);
        q.qmc = mul(T(prm.qmc), ion);
        q.qmc_ci = mul(q.qmc, ci);
        q.qmc_c2 = mul(q.qmc, c2);
        q.lnorm = mul(mul(T(prm.lnorm), ion), ion);
    } else {
        q = {T(prm.qmc), T(prm.qmc_ci), T(prm.qmc_c2), T(prm.lnorm)};
    }

    T x = xp, y = yp, ux = uxh, uy = uyh, psi = psih;
    for (int i = 0; i < n_sub; ++i) {
        // K2 at the previous position (plasma.gather_fields): guard-offset
        // cell positions, invalid lanes at the dead-lane sentinel
        const T ymc = valid ? add(mul(sub(yp, y_off), inv_dy_pos), guards) : T(2.0 * NY);
        const T xmc = valid ? add(mul(sub(xp, x_off), inv_dx_pos), guards) : T(2.0 * NX);
        T acc[kOut];
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc[c] = T(0);
        int iy0, ix0;
        if (stencil_live<P>(ymc, xmc, NY, NX, iy0, ix0))
            gather_lane<P>(pl, ymc, xmc, iy0, ix0, NY, NX, acc);
        LaneFields<T> f{};
        f.exmby = mul(acc[0], inv_dx);
        f.eypbx = mul(acc[1], inv_dy);
        f.ez = acc[2];
        f.bx_c = mul(acc[3], clight);
        f.by_c = mul(acc[4], clight);
        f.bz = acc[5];
        if constexpr (LASER) {
            // plasma._laser_terms: every lane, valid or not
            T a2, a2dx, a2dy;
            laser_gather<P>(aabs, NY, NX, int(prm.guards), xp, yp, x_off, y_off, inv_dx,
                            inv_dy, a2, a2dx, a2dy);
            f.l0 = mul(mul(a2, T(0.5)), q.lnorm);
            f.l1 = mul(mul(mul(a2dx, T(0.25)), clight), q.lnorm);
            f.l2 = mul(mul(mul(a2dy, T(0.25)), clight), q.lnorm);
        }
        // the full momentum push t-1/2 -> t+1/2 in four substeps
        ux = uxh;
        uy = uyh;
        psi = psih;
#pragma unroll 1
        for (int s = 0; s < 4; ++s) substep<LASER>(ux, uy, psi, f, q, ci, c2, sdz, half);
        // the position push t -> t+1 with the momentum at t+1/2
        x = add(xp, mul(dz_ci, quot(ux, psi)));
        y = add(yp, mul(dz_ci, quot(uy, psi)));
        particle_boundary(box, boundary, x, y, ux, uy, w, valid);
        if (!temp_slice) {
            uxh = ux;
            uyh = uy;
            psih = psi;
            xp = x;
            yp = y;
        }
        // the half momentum push t+1/2 -> t+1 (the deposit's values only)
#pragma unroll 1
        for (int s = 0; s < 2; ++s) substep<LASER>(ux, uy, psi, f, q, ci, c2, sdz, half);
    }
    const T vals[kPlasmaOut] = {x, y, ux, uy, psi, uxh, uyh, psih, w};
#pragma unroll
    for (int c = 0; c < kPlasmaOut; ++c)
        if (out.f[c] != nullptr) out.f[c][p] = vals[c];
    if (out.valid != nullptr) out.valid[p] = valid;
}

// the push's |a|^2 gather alone, for its tests: (a2, a2_dx, a2_dy) of
// each lane at (xp, yp), as a (3, N) output
template <int P, typename T>
__global__ void __launch_bounds__(kPlasmaBlock)
laser_gather_kernel(T* __restrict__ out, const T* __restrict__ xp, const T* __restrict__ yp,
                    const T* __restrict__ aabs, const PlasmaParams prm, long long N, int NY,
                    int NX) {
    const long long p = (long long)blockIdx.x * kPlasmaBlock + threadIdx.x;
    if (p >= N) return;
    T a2, a2dx, a2dy;
    laser_gather<P>(aabs, NY, NX, int(prm.guards), xp[p], yp[p], T(prm.x_off), T(prm.y_off),
                    T(prm.inv_dx), T(prm.inv_dy), a2, a2dx, a2dy);
    out[p] = a2;
    out[N + p] = a2dx;
    out[2 * N + p] = a2dy;
}

template <typename T>
int launch_laser_gather(void* out, const void* xp, const void* yp, const void* aabs,
                        const double* params, long long N, int NY, int NX, int order,
                        void* stream) {
    if (N <= 0) return (int)cudaGetLastError();
    if ((long long)NY * NX >= INT_MAX) return (int)cudaErrorInvalidValue;
    PlasmaParams prm;
    double* dst = reinterpret_cast<double*>(&prm);
    for (int k = 0; k < kPlasmaParams; ++k) dst[k] = params[k];
    const unsigned grid = (unsigned)((N + kPlasmaBlock - 1) / kPlasmaBlock);
    cudaStream_t s = (cudaStream_t)stream;
    T* o = (T*)out;
    const T* x = (const T*)xp;
    const T* y = (const T*)yp;
    const T* a = (const T*)aabs;
    switch (order) {
        case 0: laser_gather_kernel<0, T><<<grid, kPlasmaBlock, 0, s>>>(o, x, y, a, prm, N, NY, NX); break;
        case 1: laser_gather_kernel<1, T><<<grid, kPlasmaBlock, 0, s>>>(o, x, y, a, prm, N, NY, NX); break;
        case 2: laser_gather_kernel<2, T><<<grid, kPlasmaBlock, 0, s>>>(o, x, y, a, prm, N, NY, NX); break;
        case 3: laser_gather_kernel<3, T><<<grid, kPlasmaBlock, 0, s>>>(o, x, y, a, prm, N, NY, NX); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

template <int P, bool LASER, typename T>
void launch_plasma(const PlasmaOut<T>& out, const PlasmaLanes<T>& in, const Planes<T>& pl,
                   const T* aabs, const PlasmaParams& prm, long long N, int NY, int NX,
                   int n_sub, int boundary, int temp_slice, cudaStream_t stream) {
    const long long grid = (N + kPlasmaBlock - 1) / kPlasmaBlock;
    plasma_push_kernel<P, LASER, T><<<(unsigned)grid, kPlasmaBlock, 0, stream>>>(
        out, in, pl, aabs, prm, N, NY, NX, n_sub, boundary, temp_slice);
}

template <int P, typename T>
void launch_order(const PlasmaOut<T>& out, const PlasmaLanes<T>& in, const Planes<T>& pl,
                  const T* aabs, const PlasmaParams& prm, long long N, int NY, int NX,
                  int n_sub, int boundary, int temp_slice, cudaStream_t stream) {
    if (aabs != nullptr)
        launch_plasma<P, true>(out, in, pl, aabs, prm, N, NY, NX, n_sub, boundary, temp_slice,
                               stream);
    else
        launch_plasma<P, false>(out, in, pl, aabs, prm, N, NY, NX, n_sub, boundary, temp_slice,
                                stream);
}

template <typename T>
int launch_plasma_push(void* const* outs, void* out_valid, const void* const* lanes,
                       const void* valid, const void* ion_lev, const void* const* planes,
                       const void* aabs, const double* params, long long N, int NY, int NX,
                       int order, int n_sub, int boundary, int temp_slice, void* stream) {
    if (N <= 0) return (int)cudaGetLastError();
    if ((long long)NY * NX >= INT_MAX || boundary < kPeriodic || boundary > kAbsorbing
        || (boundary == kAbsorbing) != (out_valid != nullptr) || n_sub < 1)
        return (int)cudaErrorInvalidValue;
    PlasmaOut<T> o;
    for (int c = 0; c < kPlasmaOut; ++c) o.f[c] = (T*)outs[c];
    o.valid = (bool*)out_valid;
    PlasmaLanes<T> in;
    for (int c = 0; c < kPlasmaIn; ++c) in.f[c] = (const T*)lanes[c];
    in.valid = (const bool*)valid;
    in.ion_lev = (const int*)ion_lev;
    Planes<T> pl;
    for (int c = 0; c < kPlanes; ++c) pl.f[c] = (const T*)planes[c];
    PlasmaParams prm;
    double* dst = reinterpret_cast<double*>(&prm);
    for (int k = 0; k < kPlasmaParams; ++k) dst[k] = params[k];
    const T* a = (const T*)aabs;
    cudaStream_t s = (cudaStream_t)stream;
    switch (order) {
        case 0: launch_order<0>(o, in, pl, a, prm, N, NY, NX, n_sub, boundary, temp_slice, s); break;
        case 1: launch_order<1>(o, in, pl, a, prm, N, NY, NX, n_sub, boundary, temp_slice, s); break;
        case 2: launch_order<2>(o, in, pl, a, prm, N, NY, NX, n_sub, boundary, temp_slice, s); break;
        case 3: launch_order<3>(o, in, pl, a, prm, N, NY, NX, n_sub, boundary, temp_slice, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace hipace

#define HIPACE_PLASMA_PUSH_EXPORT(T, SUF)                                                     \
    int hipace_plasma_push_##SUF(void* const* outs, void* out_valid, const void* const* lanes, \
                                 const void* valid, const void* ion_lev,                      \
                                 const void* const* planes, const void* aabs,                 \
                                 const double* params, long long N, int NY, int NX,           \
                                 int order, int n_sub, int boundary, int temp_slice,          \
                                 void* stream) {                                              \
        return hipace::launch_plasma_push<T>(outs, out_valid, lanes, valid, ion_lev, planes,  \
                                             aabs, params, N, NY, NX, order, n_sub, boundary, \
                                             temp_slice, stream);                             \
    }

#define HIPACE_LASER_GATHER_EXPORT(T, SUF)                                                 \
    int hipace_laser_gather_##SUF(void* out, const void* xp, const void* yp,               \
                                  const void* aabs, const double* params, long long N,     \
                                  int NY, int NX, int order, void* stream) {               \
        return hipace::launch_laser_gather<T>(out, xp, yp, aabs, params, N, NY, NX, order, \
                                              stream);                                     \
    }

extern "C" {
HIPACE_PLASMA_PUSH_EXPORT(float, f32)
HIPACE_PLASMA_PUSH_EXPORT(double, f64)
HIPACE_LASER_GATHER_EXPORT(float, f32)
HIPACE_LASER_GATHER_EXPORT(double, f64)
}
