// K3: node-centered geometric multigrid for Laplacian(u) - acf*u = rhs with
// Dirichlet ghost nodes, C channels sharing one acf (Bx, By).
//
// Replaces the TPU kernel _mg_kernel driven by FusedMG.solve
// (hipace_tpu/ops/pallas_mg.py:62-249), held to the XLA path of
// MultiGrid.solve (hipace_tpu/fields/multigrid.py:182-296): red-black
// Gauss-Seidel (red = (ix+iy) even first, nu1/nu2 sweeps, nu1 + 8 on the
// coarsest level), full-weighting restriction [1,2,1]/4 x [1,2,1]/4,
// bilinear prolongation 2R^T per dimension, exact stencils throughout (no
// reduced-precision transfers).
//
// What bounds it on the H100: memory traffic and launch latency. A colour
// sweep of the finest level reads about six values and writes one per
// updated cell; the coarse levels are tiny, so there the cost is launches.
// The TPU kernel kept the whole ladder in VMEM; here a block has 227 KB of
// shared memory, so the fine levels run as separate grid-wide kernels (one
// launch per colour, residual, stencil restriction, prolong-add) driven by
// a host V-cycle loop, and every level of at most 1024 cells runs in ONE
// single-block kernel with the levels in shared memory (ref
// HpMultiGrid.cpp:1073-1096). A max-abs reduction gives
// the convergence norm, read back once per V-cycle. Fusing several colour
// sweeps per shared-memory round trip (ref HpMultiGrid.cpp:412-560) is the
// next step.

#include "common.cuh"

namespace hipace {

constexpr int kMaxLevels = 16;

struct CoarseLevels {
    int ny[kMaxLevels];
    int nx[kMaxLevels];
    double facx[kMaxLevels];
    double facy[kMaxLevels];
    const void* invd[kMaxLevels];
    const void* dma[kMaxLevels];
};

// facx (uW + uE) + facy (uN + uS) with zero Dirichlet ghosts; uc is one
// channel's (ny, nx) plane
template <typename T>
__device__ __forceinline__ T offdiag(const T* uc, int iy, int ix, int ny, int nx,
                                     T facx, T facy) {
    const int i = iy * nx + ix;
    T uW = ix > 0 ? uc[i - 1] : T(0);
    T uE = ix < nx - 1 ? uc[i + 1] : T(0);
    T uS = iy > 0 ? uc[i - nx] : T(0);
    T uN = iy < ny - 1 ? uc[i + nx] : T(0);
    return facx * (uW + uE) + facy * (uN + uS);
}

// restriction of one coarse node (icy, icx) from a fine plane: the
// separable [1,2,1]/4 stencil, rows first as in Ry r Rx^T
template <typename T>
__device__ __forceinline__ T restrict_node(const T* fc, int icy, int icx, int nxf) {
    const int jy = 2 * icy + 1, jx = 2 * icx + 1;
    T t[3];
    for (int b = 0; b < 3; ++b) {
        const int col = jx - 1 + b;
        t[b] = T(0.25) * fc[(jy - 1) * nxf + col] + T(0.5) * fc[jy * nxf + col] +
               T(0.25) * fc[(jy + 1) * nxf + col];
    }
    return T(0.25) * t[0] + T(0.5) * t[1] + T(0.25) * t[2];
}

// bilinear prolongation of a coarse plane at fine node (jy, jx)
template <typename T>
__device__ __forceinline__ T prolong_node(const T* cc, int jy, int jx, int nyc,
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
    T v = T(0);
    for (int a = 0; a < ny_; ++a) {
        T t = T(0);
        for (int b = 0; b < nx_; ++b) t += wx[b] * cc[iy[a] * nxc + ix[b]];
        v += wy[a] * t;
    }
    return v;
}

// ---------------------------------------------------------------- grid-wide
template <typename T>
__global__ void mg_smooth_kernel(T* __restrict__ u, const T* __restrict__ rhs,
                                 const T* __restrict__ invd, int C, int ny, int nx,
                                 T facx, T facy, int color) {
    const long long n = (long long)C * ny * nx;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int ix = int(i % nx);
    const int iy = int((i / nx) % ny);
    if (((ix + iy) & 1) != color) return;
    const long long base = i - ((long long)iy * nx + ix);
    const T off = offdiag(u + base, iy, ix, ny, nx, facx, facy);
    u[i] = (rhs[i] - off) * invd[iy * nx + ix];
}

template <typename T>
__global__ void mg_residual_kernel(T* __restrict__ res, const T* __restrict__ u,
                                   const T* __restrict__ rhs,
                                   const T* __restrict__ dma, int C, int ny,
                                   int nx, T facx, T facy) {
    const long long n = (long long)C * ny * nx;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int ix = int(i % nx);
    const int iy = int((i / nx) % ny);
    const long long base = i - ((long long)iy * nx + ix);
    const T off = offdiag(u + base, iy, ix, ny, nx, facx, facy);
    res[i] = rhs[i] - (off + dma[iy * nx + ix] * u[i]);
}

template <typename T>
__global__ void mg_restrict_kernel(T* __restrict__ coarse, T* __restrict__ coarse_u,
                                   const T* __restrict__ fine, int C, int nyf,
                                   int nxf) {
    const int nyc = (nyf - 1) / 2, nxc = (nxf - 1) / 2;
    const long long n = (long long)C * nyc * nxc;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int icx = int(i % nxc);
    const int icy = int((i / nxc) % nyc);
    const int c = int(i / ((long long)nyc * nxc));
    coarse[i] = restrict_node(fine + (long long)c * nyf * nxf, icy, icx, nxf);
    if (coarse_u) coarse_u[i] = T(0);
}

template <typename T>
__global__ void mg_prolong_add_kernel(T* __restrict__ fine,
                                      const T* __restrict__ coarse, int C,
                                      int nyf, int nxf) {
    const int nyc = (nyf - 1) / 2, nxc = (nxf - 1) / 2;
    const long long n = (long long)C * nyf * nxf;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int jx = int(i % nxf);
    const int jy = int((i / nxf) % nyf);
    const int c = int(i / ((long long)nyf * nxf));
    fine[i] += prolong_node(coarse + (long long)c * nyc * nxc, jy, jx, nyc, nxc);
}

// unsigned integer of a float's width: the bit patterns of non-negative
// floats order like their values, so an integer atomicMax takes the max
template <typename T> struct Bits;
template <> struct Bits<float> { using type = unsigned int; };
template <> struct Bits<double> { using type = unsigned long long; };

__device__ __forceinline__ unsigned int to_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned long long to_bits(double v) {
    return (unsigned long long)__double_as_longlong(v);
}

// NaN-propagating max of non-negative values
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) { return (b > a || b != b) ? b : a; }

template <typename T>
__global__ void mg_maxabs_kernel(typename Bits<T>::type* __restrict__ out,
                                 const T* __restrict__ x, long long n) {
    __shared__ T part[256];
    T m = T(0);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        T a = x[i];
        m = nanmax(m, a < T(0) ? -a : a);
    }
    part[threadIdx.x] = m;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if ((int)threadIdx.x < s)
            part[threadIdx.x] = nanmax(part[threadIdx.x], part[threadIdx.x + s]);
        __syncthreads();
    }
    if (threadIdx.x == 0) atomicMax(out, to_bits(part[0]));
}

// ------------------------------------------------------ single-block coarse
template <typename T>
__device__ void block_smooth(T* u, const T* rhs, const T* invd, int C, int ny,
                             int nx, T facx, T facy, int sweeps) {
    const int n = C * ny * nx;
    for (int s = 0; s < sweeps; ++s) {
        for (int color = 0; color < 2; ++color) {
            for (int i = threadIdx.x; i < n; i += blockDim.x) {
                const int ix = i % nx, iy = (i / nx) % ny;
                if (((ix + iy) & 1) != color) continue;
                const int base = i - (iy * nx + ix);
                const T off = offdiag(u + base, iy, ix, ny, nx, facx, facy);
                u[i] = (rhs[i] - off) * invd[iy * nx + ix];
            }
            __syncthreads();
        }
    }
}

// the levels L0 .. L-1 of one V-cycle in one block: level L0's u and rhs
// come from global memory (u is the running solution when L0 = 0, zero
// otherwise) and every level lives in shared memory
template <typename T>
__global__ void mg_coarse_kernel(T* __restrict__ u_g, const T* __restrict__ rhs_g,
                                 int C, int L0, int L, CoarseLevels lv, int nu1,
                                 int nu2, int coarse_sweeps) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sm = reinterpret_cast<T*>(smem_raw);
    T* us[kMaxLevels];
    T* rs[kMaxLevels];
    T* ptr = sm;
    for (int l = L0; l < L; ++l) {
        const int n = C * lv.ny[l] * lv.nx[l];
        us[l] = ptr; ptr += n;
        rs[l] = ptr; ptr += n;
    }
    T* res = ptr;
    const int n0 = C * lv.ny[L0] * lv.nx[L0];
    for (int i = threadIdx.x; i < n0; i += blockDim.x) {
        us[L0][i] = u_g[i];
        rs[L0][i] = rhs_g[i];
    }
    __syncthreads();
    for (int l = L0; l < L - 1; ++l) {
        const int ny = lv.ny[l], nx = lv.nx[l];
        const T fx = T(lv.facx[l]), fy = T(lv.facy[l]);
        block_smooth(us[l], rs[l], (const T*)lv.invd[l], C, ny, nx, fx, fy, nu1);
        const T* dma = (const T*)lv.dma[l];
        const int n = C * ny * nx;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int ix = i % nx, iy = (i / nx) % ny;
            const int base = i - (iy * nx + ix);
            const T off = offdiag(us[l] + base, iy, ix, ny, nx, fx, fy);
            res[i] = rs[l][i] - (off + dma[iy * nx + ix] * us[l][i]);
        }
        __syncthreads();
        const int nyc = lv.ny[l + 1], nxc = lv.nx[l + 1];
        const int nc = C * nyc * nxc;
        for (int i = threadIdx.x; i < nc; i += blockDim.x) {
            const int icx = i % nxc, icy = (i / nxc) % nyc, c = i / (nyc * nxc);
            rs[l + 1][i] = restrict_node(res + c * ny * nx, icy, icx, nx);
            us[l + 1][i] = T(0);
        }
        __syncthreads();
    }
    block_smooth(us[L - 1], rs[L - 1], (const T*)lv.invd[L - 1], C, lv.ny[L - 1],
                 lv.nx[L - 1], T(lv.facx[L - 1]), T(lv.facy[L - 1]),
                 nu1 + coarse_sweeps);
    for (int l = L - 2; l >= L0; --l) {
        const int ny = lv.ny[l], nx = lv.nx[l];
        const int nyc = lv.ny[l + 1], nxc = lv.nx[l + 1];
        const int n = C * ny * nx;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int jx = i % nx, jy = (i / nx) % ny, c = i / (ny * nx);
            us[l][i] += prolong_node(us[l + 1] + c * nyc * nxc, jy, jx, nyc, nxc);
        }
        __syncthreads();
        block_smooth(us[l], rs[l], (const T*)lv.invd[l], C, ny, nx,
                     T(lv.facx[l]), T(lv.facy[l]), nu2);
    }
    for (int i = threadIdx.x; i < n0; i += blockDim.x) u_g[i] = us[L0][i];
}

// ---------------------------------------------------------------- launchers
inline unsigned blocks_for(long long n, int block) {
    return (unsigned)((n + block - 1) / block);
}

template <typename T>
int launch_smooth(void* u, const void* rhs, const void* invd, int C, int ny, int nx,
                  double facx, double facy, int color, void* stream) {
    const long long n = (long long)C * ny * nx;
    mg_smooth_kernel<T><<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (T*)u, (const T*)rhs, (const T*)invd, C, ny, nx, T(facx), T(facy), color);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_residual(void* res, const void* u, const void* rhs, const void* dma,
                    int C, int ny, int nx, double facx, double facy, void* stream) {
    const long long n = (long long)C * ny * nx;
    mg_residual_kernel<T><<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (T*)res, (const T*)u, (const T*)rhs, (const T*)dma, C, ny, nx, T(facx),
        T(facy));
    return (int)cudaGetLastError();
}

template <typename T>
int launch_restrict(void* coarse, void* coarse_u, const void* fine, int C, int nyf,
                    int nxf, void* stream) {
    const long long n = (long long)C * ((nyf - 1) / 2) * ((nxf - 1) / 2);
    mg_restrict_kernel<T><<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (T*)coarse, (T*)coarse_u, (const T*)fine, C, nyf, nxf);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_prolong_add(void* fine, const void* coarse, int C, int nyf, int nxf,
                       void* stream) {
    const long long n = (long long)C * nyf * nxf;
    mg_prolong_add_kernel<T><<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (T*)fine, (const T*)coarse, C, nyf, nxf);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_maxabs(void* out_bits, const void* x, long long n, void* stream) {
    using B = typename Bits<T>::type;
    cudaError_t err = cudaMemsetAsync(out_bits, 0, sizeof(B), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    unsigned grid = blocks_for(n > 0 ? n : 1, 256);
    if (grid > 1024) grid = 1024;
    mg_maxabs_kernel<T><<<grid, 256, 0, (cudaStream_t)stream>>>((B*)out_bits,
                                                              (const T*)x, n);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_coarse(void* u, const void* rhs, int C, int L0, int L, const int* ny,
                  const int* nx, const double* facx, const double* facy,
                  const unsigned long long* invd, const unsigned long long* dma,
                  int nu1, int nu2, int coarse_sweeps, int smem_bytes,
                  void* stream) {
    if (L > kMaxLevels || L0 < 0 || L0 >= L) return (int)cudaErrorInvalidValue;
    CoarseLevels lv;
    for (int l = 0; l < L; ++l) {
        lv.ny[l] = ny[l];
        lv.nx[l] = nx[l];
        lv.facx[l] = facx[l];
        lv.facy[l] = facy[l];
        lv.invd[l] = (const void*)invd[l];
        lv.dma[l] = (const void*)dma[l];
    }
    cudaError_t err = cudaFuncSetAttribute(
        mg_coarse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    mg_coarse_kernel<T><<<1, 512, smem_bytes, (cudaStream_t)stream>>>(
        (T*)u, (const T*)rhs, C, L0, L, lv, nu1, nu2, coarse_sweeps);
    return (int)cudaGetLastError();
}

}  // namespace hipace

#define HIPACE_MG_EXPORTS(T, SUF)                                                 \
    int hipace_mg_smooth_##SUF(void* u, const void* rhs, const void* invd, int C, \
                               int ny, int nx, double facx, double facy,          \
                               int color, void* stream) {                         \
        return hipace::launch_smooth<T>(u, rhs, invd, C, ny, nx, facx, facy,      \
                                        color, stream);                           \
    }                                                                             \
    int hipace_mg_residual_##SUF(void* res, const void* u, const void* rhs,       \
                                 const void* dma, int C, int ny, int nx,          \
                                 double facx, double facy, void* stream) {        \
        return hipace::launch_residual<T>(res, u, rhs, dma, C, ny, nx, facx,      \
                                          facy, stream);                          \
    }                                                                             \
    int hipace_mg_restrict_##SUF(void* coarse, void* coarse_u, const void* fine,  \
                                 int C, int nyf, int nxf, void* stream) {         \
        return hipace::launch_restrict<T>(coarse, coarse_u, fine, C, nyf, nxf,    \
                                          stream);                                \
    }                                                                             \
    int hipace_mg_prolong_add_##SUF(void* fine, const void* coarse, int C,        \
                                    int nyf, int nxf, void* stream) {             \
        return hipace::launch_prolong_add<T>(fine, coarse, C, nyf, nxf, stream);  \
    }                                                                             \
    int hipace_mg_maxabs_##SUF(void* out_bits, const void* x, long long n,        \
                               void* stream) {                                    \
        return hipace::launch_maxabs<T>(out_bits, x, n, stream);                  \
    }                                                                             \
    int hipace_mg_coarse_##SUF(void* u, const void* rhs, int C, int L0, int L,    \
                               const void* ny, const void* nx, const void* facx,  \
                               const void* facy, const void* invd,                \
                               const void* dma, int nu1, int nu2,                 \
                               int coarse_sweeps, int smem_bytes, void* stream) { \
        return hipace::launch_coarse<T>(                                          \
            u, rhs, C, L0, L, (const int*)ny, (const int*)nx,                     \
            (const double*)facx, (const double*)facy,                             \
            (const unsigned long long*)invd, (const unsigned long long*)dma, nu1, \
            nu2, coarse_sweeps, smem_bytes, stream);                              \
    }

extern "C" {
HIPACE_MG_EXPORTS(float, f32)
HIPACE_MG_EXPORTS(double, f64)
}
