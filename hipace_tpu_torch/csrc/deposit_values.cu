// The plasma deposit's values: one plasma species' per-lane channel values
// for K1 on one slice, in one launch (ref PlasmaDepositCurrent.cpp:22-257
// and ExplicitDeposition.cpp, the explicit solver's deposit). Per lane:
// 1/psi, the velocities, with a laser |a|^2 at the lane (laser_gather.cuh)
// times the species' laser factor, gamma psi, the quasi-static test (the
// bad flag and the weight mask), with an ionizable species the ion level's
// factors, the main channels (jx, jy, jz, rho, chi, rhomjz), the five Sx/Sy
// coefficient channels (six with the laser) and the four derivative
// channels; it writes the (C, N) value rows K1 reads, in the caller's row
// order, K1's guard-offset cell positions (dead and masked-out lanes at the
// sentinel 2 NY, 2 NX), and the species' new w and valid. On a fine
// mesh-refinement level an optional lane mask scales the weights and moves
// masked-out lanes to the sentinel. The plain version is
// deposit_values_plain in hipace_tpu_torch/ops/deposit_values.py (the lane
// algebra of particles/plasma.py fused_plasma_deposits), and this kernel
// computes what it computes on the card, lane by lane.
//
// Replaces no Pallas kernel of its own: it computes the lane algebra that
// the JAX package's fused_plasma_deposits runs on XLA before its K1 call
// (pallas_deposit_multi, hipace_tpu/ops/pallas_banded.py:512), and the
// |a|^2 gather (gather_laser_aabs, XLA) that enters gamma. On the card that
// algebra was ~80 PyTorch elementwise launches per species and slice, and
// the gather ~20 more over (N, m+2, m+2) index blocks: ~3.3 ms per slice of
// 4.19M float64 lanes, ~10.6 ms with the laser.
//
// What bounds it on the H100: bytes. Each lane reads six floats and valid
// (49 B in float64; the ion level and the mask where given) and writes C
// value rows, two positions, w and valid (C = 17 with the laser's sixth
// coefficient channel and rho: 161 B), and the |a|^2 plane is read once:
// at 2047^2 with 4,190,209 lanes ~0.7-0.8 GB, ~0.22 ms at 3.35 TB/s. Its
// ~60 operations per lane (~120 with the |a|^2 value at order 2) are far
// below the FLOP peak.
//
// Design: one thread per lane, as in the fused pushes; each row written
// coalesced. The order (for the |a|^2 gather's stencil) and the laser are
// template parameters; the ion levels and the mask are pointers, null where
// not given, uniform over the launch. The caller's row order comes as a
// code per row, which the launch turns into each value's rows (ValueRows,
// a bit mask among the kernel's parameters). Every rounding step
// is written with the _rn intrinsics in the plain version's order, and each
// scalar enters in the working type as PyTorch's ops take the plain
// version's Python floats (computed on the host), so that the results are
// the plain version's bit for bit; the |a|^2 gather is the fused plasma
// push's (laser_gather.cuh: the plain gather's order of sums).

#include "laser_gather.cuh"
#include "push_common.cuh"

#include <climits>

namespace hipace {

constexpr int kValuesBlock = 256;   // lanes per block
constexpr int kValuesIn = 6;        // x, y, ux, uy, psi, w
constexpr int kMaxRows = 32;        // K1's channel limit

// the value codes of a row, in the plain version's names
enum ValueCode {
    kJx = 0, kJy, kJz, kRho, kChi, kRhomjz,    // the main channels
    kS0, kS1, kS2, kS3, kS4, kS5,              // the Sx/Sy coefficients
    kV2a, kV2b, kV3a, kV3b,                    // the derivative channels
    kNumCodes
};

// the values' scalars, as the plain version's Python floats (the order of
// PARAMS in ops/deposit_values.py)
struct ValuesParams {
    double q_invvol;                // charge * invvol
    double q_mu0_m;                 // charge * mu0 / mass
    double q_m;                     // charge / mass
    double lnorm;                   // the laser's factor ((q/e)(m_e/m))^2
    double cin, clight;             // 1/c, c
    double cd_mu0;                  // charge * invvol * mu0
    double max_qsa;                 // max_qsa_weighting_factor
    double inv_dx, inv_dy;          // 1/dx, 1/dy in double
    double x_off, y_off;            // the grid's position offsets
    double guards;                  // guard cells
};
constexpr int kValuesParams = sizeof(ValuesParams) / sizeof(double);

// per value code, the rows that take it (bit r: row r)
struct ValueRows {
    unsigned rows[kNumCodes];
};

template <typename T>
struct ValuesLanes {
    const T* f[kValuesIn];
    const bool* valid;
    const int* ion_lev;     // null where the species does not ionize
    const bool* mask;       // null but on a fine level
};

template <typename T>
struct ValuesOut {
    T* rows;                // (C, N)
    T* pos;                 // (2, N): ym, xm
    T* w;
    bool* valid;
};

template <int P, bool LASER, typename T>
__global__ void __launch_bounds__(kValuesBlock)
plasma_deposit_values_kernel(const ValuesOut<T> out, const ValuesLanes<T> in,
                             const T* __restrict__ aabs, const ValuesParams prm,
                             const ValueRows rows, long long N, int NY, int NX,
                             int NYa, int NXa) {
    const long long p = (long long)blockIdx.x * kValuesBlock + threadIdx.x;
    if (p >= N) return;
    const T x = in.f[0][p], y = in.f[1][p], ux = in.f[2][p], uy = in.f[3][p];
    const T psi = in.f[4][p], w = in.f[5][p];
    const bool valid = in.valid[p];
    const bool has_mask = in.mask != nullptr;
    const bool inside = has_mask ? in.mask[p] : true;

    const T cin = T(prm.cin), clight = T(prm.clight);
    const T psi_inv = quot(T(1), psi);
    const T vx_c = mul(ux, psi_inv), vy_c = mul(uy, psi_inv);  // velocity * c
    const T vx = mul(vx_c, cin), vy = mul(vy_c, cin);          // dimensionless
    T q_invvol = mul(T(prm.q_invvol), w);
    T q_mu0_m = T(prm.q_mu0_m), q_m = T(prm.q_m), lnorm = T(prm.lnorm);
    T ion = T(1);
    if (in.ion_lev != nullptr) {
        // each lane's charge is its level times the species' (R16)
        ion = T(in.ion_lev[p]);
        q_invvol = mul(q_invvol, ion);
        q_mu0_m = mul(q_mu0_m, ion);
        q_m = mul(q_m, ion);
        lnorm = mul(mul(lnorm, ion), ion);
    }
    const T vxvx = mul(vx, vx), vyvy = mul(vy, vy);
    T s;
    if constexpr (LASER) {
        // |a|^2 at the lane, every lane valid or not (gather_laser_aabs)
        T a2, a2dx, a2dy;
        laser_gather<P>(aabs, NYa, NXa, int(prm.guards), x, y, T(prm.x_off), T(prm.y_off),
                        T(prm.inv_dx), T(prm.inv_dy), a2, a2dx, a2dy);
        a2 = mul(a2, lnorm);
        s = mul(mul(add(T(1), mul(T(0.5), a2)), psi_inv), psi_inv);
    } else {
        s = mul(psi_inv, psi_inv);
    }
    s = add(add(add(s, vxvx), vyvy), T(1));
    const T gamma = mul(T(0.5), s);
    // the quasi-static test (plasma._qsa_mask): NaN passes
    const bool bad = gamma < T(0) || gamma > T(prm.max_qsa) || psi_inv < T(0);
    const T wmask = (valid && !bad) ? T(1) : T(0);
    q_invvol = mul(q_invvol, has_mask ? mul(wmask, inside ? T(1) : T(0)) : wmask);

    // the explicit coefficient channels; on a fine level the masked valid
    // lanes weigh without the quasi-static test
    T cd = mul(T(prm.cd_mu0), w);
    cd = mul(cd, has_mask ? ((valid && inside) ? T(1) : T(0)) : wmask);
    if (in.ion_lev != nullptr) cd = mul(cd, ion);
    const T qm_psi = mul(q_m, psi_inv);
    const T base = mul(cd, qm_psi);
    const T cdc = mul(cd, clight);
    const T cdx = mul(cdc, T(prm.inv_dx));
    const T ncdy = mul(-cdc, T(prm.inv_dy));
    const T g_vy = sub(gamma, vyvy), g_vx = sub(gamma, vxvx);

    T vals[kNumCodes];
    vals[kJx] = mul(q_invvol, vx_c);
    vals[kJy] = mul(q_invvol, vy_c);
    vals[kJz] = mul(mul(q_invvol, sub(gamma, T(1))), clight);
    vals[kRho] = mul(q_invvol, gamma);
    vals[kChi] = mul(mul(q_invvol, q_mu0_m), psi_inv);
    vals[kRhomjz] = q_invvol;
    vals[kS0] = mul(base, vx);
    vals[kS1] = mul(base, vy);
    vals[kS2] = mul(mul(mul(base, vx), vy), cin);
    vals[kS3] = mul(mul(base, g_vy), cin);
    vals[kS4] = mul(mul(base, g_vx), cin);
    vals[kS5] = LASER ? mul(mul(T(0.25), base), qm_psi) : T(0);
    vals[kV2a] = mul(mul(cdx, vx), vy);
    vals[kV2b] = mul(cdx, sub(g_vx, T(1)));
    vals[kV3a] = mul(ncdy, sub(g_vy, T(1)));
    vals[kV3b] = mul(mul(ncdy, vx), vy);
    // each value into the rows that take it (uniform over the launch; rho
    // may fill two rows, rho and rho_<species>)
#pragma unroll
    for (int k = 0; k < kNumCodes; ++k) {
        for (unsigned m = rows.rows[k]; m != 0; m &= m - 1)
            out.rows[(long long)(__ffs(m) - 1) * N + p] = vals[k];
    }

    // K1's guard-offset cell positions (plasma.cell_positions): lanes that
    // are invalid or outside the mask at the dead-lane sentinel
    const bool live = valid && inside;
    // (a division by a Python scalar is PyTorch's multiply by the working
    // type's rounding of its reciprocal in double)
    out.pos[p] = live ? add(mul(sub(y, T(prm.y_off)), T(prm.inv_dy)), T(prm.guards))
                      : T(2.0 * NY);
    out.pos[N + p] = live ? add(mul(sub(x, T(prm.x_off)), T(prm.inv_dx)), T(prm.guards))
                          : T(2.0 * NX);
    out.w[p] = mul(w, wmask);
    out.valid[p] = valid && !bad;
}

template <int P, bool LASER, typename T>
void launch_values(const ValuesOut<T>& out, const ValuesLanes<T>& in, const T* aabs,
                   const ValuesParams& prm, const ValueRows& rows, long long N, int NY,
                   int NX, int NYa, int NXa, cudaStream_t stream) {
    const long long grid = (N + kValuesBlock - 1) / kValuesBlock;
    plasma_deposit_values_kernel<P, LASER, T><<<(unsigned)grid, kValuesBlock, 0, stream>>>(
        out, in, aabs, prm, rows, N, NY, NX, NYa, NXa);
}

template <typename T>
int launch_deposit_values(void* rows, void* pos, void* w_out, void* valid_out,
                          const void* const* lanes, const void* valid, const void* ion_lev,
                          const void* mask, const void* aabs, const double* params,
                          const int* codes, int C, long long N, int NY, int NX, int NYa,
                          int NXa, int order, void* stream) {
    if (N <= 0) return (int)cudaGetLastError();
    if (C < 1 || C > kMaxRows || (long long)NYa * NXa >= INT_MAX)
        return (int)cudaErrorInvalidValue;
    ValueRows vr;
    for (int k = 0; k < kNumCodes; ++k) vr.rows[k] = 0u;
    for (int r = 0; r < C; ++r) {
        if (codes[r] < 0 || codes[r] >= kNumCodes) return (int)cudaErrorInvalidValue;
        vr.rows[codes[r]] |= 1u << r;
    }
    ValuesOut<T> o{(T*)rows, (T*)pos, (T*)w_out, (bool*)valid_out};
    ValuesLanes<T> in;
    for (int c = 0; c < kValuesIn; ++c) in.f[c] = (const T*)lanes[c];
    in.valid = (const bool*)valid;
    in.ion_lev = (const int*)ion_lev;
    in.mask = (const bool*)mask;
    ValuesParams prm;
    double* dst = reinterpret_cast<double*>(&prm);
    for (int k = 0; k < kValuesParams; ++k) dst[k] = params[k];
    const T* a = (const T*)aabs;
    cudaStream_t s = (cudaStream_t)stream;
    if (a == nullptr) {
        launch_values<0, false>(o, in, a, prm, vr, N, NY, NX, NYa, NXa, s);
        return (int)cudaGetLastError();
    }
    switch (order) {
        case 0: launch_values<0, true>(o, in, a, prm, vr, N, NY, NX, NYa, NXa, s); break;
        case 1: launch_values<1, true>(o, in, a, prm, vr, N, NY, NX, NYa, NXa, s); break;
        case 2: launch_values<2, true>(o, in, a, prm, vr, N, NY, NX, NYa, NXa, s); break;
        case 3: launch_values<3, true>(o, in, a, prm, vr, N, NY, NX, NYa, NXa, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace hipace

#define HIPACE_DEPOSIT_VALUES_EXPORT(T, SUF)                                                  \
    int hipace_deposit_values_##SUF(void* rows, void* pos, void* w_out, void* valid_out,      \
                                    const void* const* lanes, const void* valid,              \
                                    const void* ion_lev, const void* mask, const void* aabs,  \
                                    const double* params, const int* codes, int C,            \
                                    long long N, int NY, int NX, int NYa, int NXa, int order, \
                                    void* stream) {                                           \
        return hipace::launch_deposit_values<T>(rows, pos, w_out, valid_out, lanes, valid,    \
                                                ion_lev, mask, aabs, params, codes, C, N, NY, \
                                                NX, NYa, NXa, order, stream);                 \
    }

extern "C" {
HIPACE_DEPOSIT_VALUES_EXPORT(float, f32)
HIPACE_DEPOSIT_VALUES_EXPORT(double, f64)
}
