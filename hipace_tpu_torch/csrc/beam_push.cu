// Fused beam push: one beam species' whole subcycle loop on one slice, in one
// launch (ref BeamParticleAdvance.cpp:19-336 without external fields, spin
// and radiation reaction). Per lane and subcycle: the slip and stop test
// against min_z with the resume counter nsub, the half-step position, the
// transverse particle boundary (Periodic, Reflecting, Absorbing), K2's gather
// of the five planes at the half-step position (gather.cuh), the momentum and
// position update, and the masked write-back; then the counter of completed
// lanes is reset. The plain version is beam_push_plain in
// hipace_tpu_torch/ops/beam_push.py (the port's subcycle loop, which keeps
// every other push), and this kernel computes what that loop computes on the
// card, lane by lane.
//
// Replaces the JAX package's subcycle loop of a beam species
// (hipace_tpu/particles/beam.py advance_beam_slice) and the beam calls of the
// TPU kernel _gather_main_kernel that it makes once per subcycle
// (pallas_gather_main, hipace_tpu/ops/pallas_banded.py:663). On the card
// that loop was ~126 PyTorch launches per subcycle over ~42k lanes, each
// shorter than the host's time to enqueue it, so the host paced the slice.
//
// What bounds it on the H100: latency. A slice's lanes are read and written
// once (seven floats, the valid flag and the counter) and the planes' cells
// under their stencils (a few hundred cells square of the plane) are read
// through L2; with ~274 operations per lane and subcycle, 42k lanes in
// float64 could take 3.4 us (0.115 GFLOP at 34 TFLOP/s; 6.9 MB at 3.35 TB/s
// takes 2.1 us). It takes ~126 us on an H100 at 700 W: each lane's
// subcycles are a chain of dependent steps, each waiting on its gather's
// loads, and 42k lanes fill only ~10 warps per SM.
//
// Design: one thread per lane, for two reasons. A lane's subcycles touch
// nothing but that lane and the five planes, which stay fixed during the
// push, so its state stays in registers across the loop and nothing is
// shared between threads. And the loop's order per lane is the plain
// version's, so the results are the plain version's: every rounding step of
// the push is written with the _rn intrinsics in the plain loop's order, so
// that no multiply and add are contracted where the loop rounds twice, and
// each scalar enters in the working type as PyTorch's elementwise ops take
// it (the parameters are computed on the host, as the loop's Python scalars
// are). The gather is K2's own code. The block size is fixed and the grid
// is ceil(N / block).

#include "gather.cuh"
#include "push_common.cuh"

#include <climits>

namespace hipace {

constexpr int kPushBlock = 128;   // lanes per block

// the push's scalars, as the plain loop's Python floats (the order of
// PARAMS in ops/beam_push.py)
struct PushParams {
    double min_z;       // the slice's lower z edge
    double half_dt;     // 0.5 dt (dt of one subcycle)
    double dt;          // dt of one subcycle
    double dt_qm;       // dt q/m
    double half_dt_qm;  // 0.5 dt q/m
    double clight;      // c
    double inv_c2;      // 1/c^2
    double lo0, lo1, hi0, hi1;     // the boundary's box
    double lx, ly, two_lx, two_ly; // its widths, and twice them
    double x_off, y_off;           // the grid's position offsets
    double inv_dx_pos, inv_dy_pos; // 1/dx, 1/dy in the working type
    double guards;                 // guard cells
    double inv_dx, inv_dy;         // 1/dx, 1/dy in double
};
constexpr int kParams = sizeof(PushParams) / sizeof(double);

// 1 / sqrt(1 + (a^2 + b^2 + c^2) / c^2), the loop's gamma inverse
template <typename T>
__device__ __forceinline__ T gamma_inv(T a, T b, T c, T inv_c2) {
    const T s = add(add(mul(a, a), mul(b, b)), mul(c, c));
    return quot(T(1), root(add(T(1), mul(s, inv_c2))));
}

template <typename T>
struct Lanes {
    const T* f[7];            // x, y, z, ux, uy, uz, w
    const bool* valid;
    const int* nsub;
    const int* beam_id;       // null with one species
};

template <typename T>
struct LanesOut {
    T* f;                     // (7, N): x, y, z, ux, uy, uz, w
    bool* valid;
    int* nsub;
};

template <int P, typename T>
__global__ void __launch_bounds__(kPushBlock)
beam_push_kernel(const LanesOut<T> out, const Lanes<T> in, const Planes<T> pl,
                 const PushParams prm, long long N, int NY, int NX, int n_sub,
                 int species, int boundary, int do_z_push) {
    const long long p = (long long)blockIdx.x * kPushBlock + threadIdx.x;
    if (p >= N) return;
    T x = in.f[0][p], y = in.f[1][p], z = in.f[2][p];
    T ux = in.f[3][p], uy = in.f[4][p], uz = in.f[5][p], w = in.f[6][p];
    bool valid = in.valid[p];
    const int nsub0 = in.nsub[p];
    const bool mine = species < 0 || in.beam_id[p] == species;
    int nsub = nsub0;
    bool stopped = false;

    const T min_z = T(prm.min_z), half_dt = T(prm.half_dt), dt = T(prm.dt);
    const T dt_qm = T(prm.dt_qm), half_dt_qm = T(prm.half_dt_qm);
    const T clight = T(prm.clight), inv_c2 = T(prm.inv_c2);
    const Box<T> box{T(prm.lo0), T(prm.lo1), T(prm.hi0), T(prm.hi1),
                     T(prm.lx), T(prm.ly), T(prm.two_lx), T(prm.two_ly)};
    const T x_off = T(prm.x_off), y_off = T(prm.y_off);
    const T inv_dx_pos = T(prm.inv_dx_pos), inv_dy_pos = T(prm.inv_dy_pos);
    const T guards = T(prm.guards);
    const T inv_dx = T(prm.inv_dx), inv_dy = T(prm.inv_dy);

    for (int i = 0; i < n_sub; ++i) {
        const bool slipped = z < min_z;
        const bool due = valid && nsub0 <= i;
        const bool active = due && !stopped && !slipped && mine;
        stopped = stopped || (slipped && due);
        if (!active) continue;

        const T gi = gamma_inv(ux, uy, uz, inv_c2);
        T xh = add(x, mul(mul(half_dt, ux), gi));
        T yh = add(y, mul(mul(half_dt, uy), gi));
        // the transverse boundary (plasma.enforce_particle_bc)
        T ux_b = ux, uy_b = uy, w_b = w;
        bool val_b = valid;
        particle_boundary(box, boundary, xh, yh, ux_b, uy_b, w_b, val_b);
        // K2 at the half-step position (plasma.gather_fields): guard-offset
        // cell positions, masked-out lanes at the dead-lane sentinel
        const T ymc = val_b ? add(mul(sub(yh, y_off), inv_dy_pos), guards) : T(2.0 * NY);
        const T xmc = val_b ? add(mul(sub(xh, x_off), inv_dx_pos), guards) : T(2.0 * NX);
        T acc[kOut];
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc[c] = T(0);
        int iy0, ix0;
        if (stencil_live<P>(ymc, xmc, NY, NX, iy0, ix0))
            gather_lane<P>(pl, ymc, xmc, iy0, ix0, NY, NX, acc);
        const T exmby = mul(acc[0], inv_dx), eypbx = mul(acc[1], inv_dy);
        const T ez = acc[2], bx = acc[3], by = acc[4], bz = acc[5];

        const T ux_n = add(ux_b, mul(dt_qm, add(add(exmby, mul(sub(clight, mul(uz, gi)), by)),
                                                mul(mul(uy_b, gi), bz))));
        const T uy_n = add(uy_b, mul(dt_qm, sub(add(eypbx, mul(sub(mul(uz, gi), clight), bx)),
                                                mul(mul(ux_b, gi), bz))));
        const T ux_mid = mul(T(0.5), add(ux_n, ux_b));
        const T uy_mid = mul(T(0.5), add(uy_n, uy_b));
        const T uz_mid = add(uz, mul(half_dt_qm, ez));
        const T gmi = gamma_inv(ux_mid, uy_mid, uz_mid, inv_c2);
        const T uz_n = add(uz, mul(dt_qm, add(ez, mul(sub(mul(ux_mid, by), mul(uy_mid, bx)), gmi))));
        const T gni = gamma_inv(ux_n, uy_n, uz_n, inv_c2);
        x = add(xh, mul(mul(half_dt, ux_n), gni));
        y = add(yh, mul(mul(half_dt, uy_n), gni));
        if (do_z_push) z = add(z, mul(dt, sub(mul(uz_n, gni), clight)));
        ux = ux_n;
        uy = uy_n;
        uz = uz_n;
        w = w_b;
        valid = val_b;
        nsub = i + 1;
    }
    // completed lanes reset their counter for the next step
    if (mine && nsub >= n_sub) nsub = 0;
    const T vals[7] = {x, y, z, ux, uy, uz, w};
#pragma unroll
    for (int c = 0; c < 7; ++c) out.f[c * N + p] = vals[c];
    out.valid[p] = valid;
    out.nsub[p] = nsub;
}

template <int P, typename T>
void launch_push(const LanesOut<T>& out, const Lanes<T>& in, const Planes<T>& pl,
            const PushParams& prm, long long N, int NY, int NX, int n_sub, int species,
            int boundary, int do_z_push, cudaStream_t stream) {
    const long long grid = (N + kPushBlock - 1) / kPushBlock;
    beam_push_kernel<P, T><<<(unsigned)grid, kPushBlock, 0, stream>>>(
        out, in, pl, prm, N, NY, NX, n_sub, species, boundary, do_z_push);
}

template <typename T>
int launch_beam_push(void* out, void* out_valid, void* out_nsub, const void* const* lanes,
                     const void* valid, const void* nsub, const void* beam_id,
                     const void* const* planes, const double* params, long long N, int NY,
                     int NX, int order, int n_sub, int species, int boundary, int do_z_push,
                     void* stream) {
    if (N <= 0) return (int)cudaGetLastError();
    if ((long long)NY * NX >= INT_MAX || boundary < kPeriodic || boundary > kAbsorbing
        || (species >= 0 && beam_id == nullptr))
        return (int)cudaErrorInvalidValue;
    LanesOut<T> o{(T*)out, (bool*)out_valid, (int*)out_nsub};
    Lanes<T> in;
    for (int c = 0; c < 7; ++c) in.f[c] = (const T*)lanes[c];
    in.valid = (const bool*)valid;
    in.nsub = (const int*)nsub;
    in.beam_id = (const int*)beam_id;
    Planes<T> pl;
    for (int c = 0; c < kPlanes; ++c) pl.f[c] = (const T*)planes[c];
    PushParams prm;
    double* dst = reinterpret_cast<double*>(&prm);
    for (int k = 0; k < kParams; ++k) dst[k] = params[k];
    cudaStream_t s = (cudaStream_t)stream;
    switch (order) {
        case 0: launch_push<0>(o, in, pl, prm, N, NY, NX, n_sub, species, boundary, do_z_push, s); break;
        case 1: launch_push<1>(o, in, pl, prm, N, NY, NX, n_sub, species, boundary, do_z_push, s); break;
        case 2: launch_push<2>(o, in, pl, prm, N, NY, NX, n_sub, species, boundary, do_z_push, s); break;
        case 3: launch_push<3>(o, in, pl, prm, N, NY, NX, n_sub, species, boundary, do_z_push, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace hipace

#define HIPACE_BEAM_PUSH_EXPORT(T, SUF)                                                      \
    int hipace_beam_push_##SUF(void* out, void* out_valid, void* out_nsub,                   \
                               const void* const* lanes, const void* valid, const void* nsub, \
                               const void* beam_id, const void* const* planes,               \
                               const double* params, long long N, int NY, int NX, int order,  \
                               int n_sub, int species, int boundary, int do_z_push,          \
                               void* stream) {                                               \
        return hipace::launch_beam_push<T>(out, out_valid, out_nsub, lanes, valid, nsub,     \
                                           beam_id, planes, params, N, NY, NX, order, n_sub, \
                                           species, boundary, do_z_push, stream);            \
    }

extern "C" {
HIPACE_BEAM_PUSH_EXPORT(float, f32)
HIPACE_BEAM_PUSH_EXPORT(double, f64)
}
