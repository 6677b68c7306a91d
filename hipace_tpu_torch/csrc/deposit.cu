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
// each, and neighbouring particles hit the same cells, so one global atomic
// per tap contends in L2. The TPU kernel's windows, rolls, bf16x3 dots and
// corrective passes existed only to stay exact inside fixed VMEM windows;
// none of them carry over.
//
// Design: a block of 256 lanes accumulates per cell and flushes each
// touched cell once (ref DepositionUtil.H:40-120). With the caller's
// lattice width the block takes a 16 x 16 patch of the particle lattice
// (plasma lanes are in lattice order, so the patch starts compact),
// otherwise 256 consecutive lanes. Floating-point atomics on shared memory
// are compare-and-swap loops on this card (measured: a shared tile of float
// atomics ran at half the speed of global atomics), so the block does not
// scatter into a tile. It stages its lanes' stencil weights and values in
// shared memory and bins the lanes by stencil origin with native integer
// atomics (up to kCap lanes per origin cell of a 32 x 32 box); then every
// thread owns output cells, gathers the lanes whose stencils reach its
// cell, sums all channels in registers with no atomics, and adds each
// sum to global memory once, rows of consecutive cells per warp. A lane
// beyond kCap in its origin cell deposits straight to global memory, and
// so does every lane of a block whose origins do not fit the box: that
// path is exact for any lane order, and the block counts itself in
// *direct_blocks. Each lane evaluates its stencil weights once for both
// kinds; zero weights (the centered-derivative stencil's two end taps for
// kind "w") are skipped.

#include "common.cuh"

#include <climits>

namespace hipace {

constexpr int kPatch = 16;                 // edge of a lattice patch
constexpr int kBlock = kPatch * kPatch;    // lanes (threads) per block
constexpr int kBin = 32;                   // edge of the box of stencil origins
constexpr int kCap = 8;                    // binned lanes per origin cell
constexpr int kChunk = 16;                 // channels summed in registers at once

// weight kinds a launch stages: "dw" only if some channel uses it
__host__ __device__ __forceinline__ int kinds_in_use(unsigned int ykind_mask,
                                                     unsigned int xkind_mask) {
    return (ykind_mask | xkind_mask) ? 2 : 1;
}

// one lane's taps straight into the field stack, one global atomic each
template <typename T>
__device__ __forceinline__ void scatter_lane(
    T* fields, const T* __restrict__ values, long long p, long long N, int C, int m,
    int iy0, int ix0, T (*wy)[kMaxTaps], T (*wx)[kMaxTaps],
    unsigned int ykind_mask, unsigned int xkind_mask, int NY, int NX) {
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
__global__ void __launch_bounds__(kBlock)
deposit_kernel(T* fields, const T* __restrict__ ym, const T* __restrict__ xm,
               const T* __restrict__ values, int C, long long N, int NY, int NX,
               int order, int deriv_type, unsigned int ykind_mask,
               unsigned int xkind_mask, int lattice_w,
               unsigned int* direct_blocks) {
    // staged per lane q: weights sw[(axis * nk + kind) * m + tap][q] for the
    // nk kinds in use and values sv[c][q]; then the bins
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int m = ntaps(order, deriv_type);
    const int nk = kinds_in_use(ykind_mask, xkind_mask);
    T* sw = reinterpret_cast<T*>(smem_raw);
    T* sv = sw + 2 * nk * m * kBlock;
    int* scount = reinterpret_cast<int*>(sv + C * kBlock);
    unsigned char* slist = reinterpret_cast<unsigned char*>(scount + kBin * kBin);
    __shared__ int box[4];   // min and max stencil origin: ylo, xlo, yhi, xhi
    const int tid = threadIdx.x;
    long long p;
    if (lattice_w > 0) {
        const int patches_x = (lattice_w + kPatch - 1) / kPatch;
        const long long row =
            (long long)(blockIdx.x / patches_x) * kPatch + tid / kPatch;
        const int col = (blockIdx.x % patches_x) * kPatch + tid % kPatch;
        p = col < lattice_w ? row * lattice_w + col : N;
    } else {
        p = (long long)blockIdx.x * kBlock + tid;
    }

    T y = T(0), x = T(0);
    int iy0 = 0, ix0 = 0;
    bool live = false;
    if (p < N) {
        y = ym[p];
        x = xm[p];
        if (live_lane(y, NY)) {
            iy0 = stencil_i0(y, order, deriv_type);
            ix0 = stencil_i0(x, order, deriv_type);
            // live only if some tap lies inside the grid
            live = iy0 > -m && iy0 < NY && ix0 > -m && ix0 < NX;
        }
    }
    if (tid == 0) {
        box[0] = box[1] = INT_MAX;
        box[2] = box[3] = INT_MIN;
    }
    __syncthreads();
    {
        const int ylo = __reduce_min_sync(0xffffffffu, live ? iy0 : INT_MAX);
        const int xlo = __reduce_min_sync(0xffffffffu, live ? ix0 : INT_MAX);
        const int yhi = __reduce_max_sync(0xffffffffu, live ? iy0 : INT_MIN);
        const int xhi = __reduce_max_sync(0xffffffffu, live ? ix0 : INT_MIN);
        if ((tid & 31) == 0) {
            atomicMin(&box[0], ylo);
            atomicMin(&box[1], xlo);
            atomicMax(&box[2], yhi);
            atomicMax(&box[3], xhi);
        }
    }
    __syncthreads();
    const int oy0 = box[0], ox0 = box[1];
    if (oy0 == INT_MAX) return;   // no live lane in this block
    const int oh = box[2] - oy0 + 1, ow = box[3] - ox0 + 1;
    const bool binned = oh <= kBin && ow <= kBin;

    T wy[2][kMaxTaps], wx[2][kMaxTaps];
    if (live) {
        for (int k = 0; k < m; ++k) {
            T uy = y - T(iy0 + k);
            T ux = x - T(ix0 + k);
            wy[0][k] = wfun(uy, order, deriv_type, 0);
            wx[0][k] = wfun(ux, order, deriv_type, 0);
            wy[1][k] = ykind_mask ? wfun(uy, order, deriv_type, 1) : T(0);
            wx[1][k] = xkind_mask ? wfun(ux, order, deriv_type, 1) : T(0);
        }
    }
    if (!binned) {
        if (tid == 0) atomicAdd(direct_blocks, 1u);
        if (live)
            scatter_lane(fields, values, p, N, C, m, iy0, ix0, wy, wx, ykind_mask,
                         xkind_mask, NY, NX);
        return;
    }

    // stage this lane, bin it by stencil origin
    for (int i = tid; i < kBin * kBin; i += kBlock) scount[i] = 0;
    if (live) {
        for (int kind = 0; kind < nk; ++kind) {
            for (int k = 0; k < m; ++k) {
                sw[(kind * m + k) * kBlock + tid] = wy[kind][k];
                sw[((nk + kind) * m + k) * kBlock + tid] = wx[kind][k];
            }
        }
        for (int c = 0; c < C; ++c) sv[c * kBlock + tid] = values[(long long)c * N + p];
    }
    __syncthreads();
    if (live) {
        const int cell = (iy0 - oy0) * kBin + (ix0 - ox0);
        const int slot = atomicAdd(&scount[cell], 1);
        if (slot < kCap)
            slist[cell * kCap + slot] = (unsigned char)tid;
        else   // the bin is full: this lane goes alone
            scatter_lane(fields, values, p, N, C, m, iy0, ix0, wy, wx, ykind_mask,
                         xkind_mask, NY, NX);
    }
    __syncthreads();

    // every thread owns output cells: gather the binned lanes whose
    // stencils reach the cell, sum in registers, add to global memory once
    const int gy0 = max(oy0, 0), gx0 = max(ox0, 0);
    const int gh = min(oy0 + oh + m - 1, NY) - gy0;
    const int gw = min(ox0 + ow + m - 1, NX) - gx0;
    const long long plane = (long long)NY * NX;
    // with only "w" channels the centered-derivative stencil's end taps
    // are zero for every lane: leave them out of the search
    const int t0 = (deriv_type == 2 && nk == 1) ? 1 : 0, t1 = m - t0;
    for (int idx = tid; idx < gh * gw; idx += kBlock) {
        const int gy = gy0 + idx / gw, gx = gx0 + idx % gw;
        for (int c0 = 0; c0 < C; c0 += kChunk) {
            T acc[kChunk];
#pragma unroll
            for (int k = 0; k < kChunk; ++k) acc[k] = T(0);
            for (int a = t0; a < t1; ++a) {
                const int oy = gy - a - oy0;
                if (oy < 0 || oy >= oh) continue;
                for (int b = t0; b < t1; ++b) {
                    const int ox = gx - b - ox0;
                    if (ox < 0 || ox >= ow) continue;
                    const int cell = oy * kBin + ox;
                    const int cnt = min(scount[cell], kCap);
                    for (int s = 0; s < cnt; ++s) {
                        const int q = slist[cell * kCap + s];
                        const T wy0 = sw[a * kBlock + q];
                        const T wx0 = sw[(nk * m + b) * kBlock + q];
                        const T wy1 = nk == 2 ? sw[(m + a) * kBlock + q] : T(0);
                        const T wx1 = nk == 2 ? sw[(3 * m + b) * kBlock + q] : T(0);
                        if ((wy0 == T(0) && wy1 == T(0)) ||
                            (wx0 == T(0) && wx1 == T(0)))
                            continue;
#pragma unroll
                        for (int k = 0; k < kChunk; ++k) {
                            const int c = c0 + k;
                            if (c < C) {
                                const T cy = ((ykind_mask >> c) & 1u) ? wy1 : wy0;
                                const T cx = ((xkind_mask >> c) & 1u) ? wx1 : wx0;
                                acc[k] += (sv[c * kBlock + q] * cy) * cx;
                            }
                        }
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
                const int c = c0 + k;
                if (c < C && acc[k] != T(0))
                    atomicAdd(fields + c * plane + (long long)gy * NX + gx, acc[k]);
            }
        }
    }
}

template <typename T>
int launch_deposit(void* fields, const void* ym, const void* xm,
                   const void* values, int C, long long N, int NY, int NX,
                   int order, int deriv_type, unsigned int ykind_mask,
                   unsigned int xkind_mask, int lattice_w, unsigned int grid,
                   void* direct_blocks, void* stream) {
    if (N <= 0) return (int)cudaGetLastError();
    if (grid == 0 || C < 1) return (int)cudaErrorInvalidValue;
    const int nk = kinds_in_use(ykind_mask, xkind_mask);
    const int smem =
        (2 * nk * ntaps(order, deriv_type) + C) * kBlock * (int)sizeof(T) +
        kBin * kBin * ((int)sizeof(int) + kCap);
    cudaError_t err = cudaFuncSetAttribute(
        deposit_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    deposit_kernel<T><<<grid, kBlock, smem, (cudaStream_t)stream>>>(
        (T*)fields, (const T*)ym, (const T*)xm, (const T*)values, C, N, NY, NX,
        order, deriv_type, ykind_mask, xkind_mask, lattice_w,
        (unsigned int*)direct_blocks);
    return (int)cudaGetLastError();
}

}  // namespace hipace

#define HIPACE_DEPOSIT_EXPORT(T, SUF)                                             \
    int hipace_deposit_##SUF(void* fields, const void* ym, const void* xm,        \
                             const void* values, int C, long long N, int NY,      \
                             int NX, int order, int deriv_type,                   \
                             unsigned int ykind_mask, unsigned int xkind_mask,    \
                             int lattice_w, unsigned int grid,                    \
                             void* direct_blocks, void* stream) {                 \
        return hipace::launch_deposit<T>(fields, ym, xm, values, C, N, NY, NX,    \
                                         order, deriv_type, ykind_mask,           \
                                         xkind_mask, lattice_w, grid,             \
                                         direct_blocks, stream);                  \
    }

extern "C" {
HIPACE_DEPOSIT_EXPORT(float, f32)
HIPACE_DEPOSIT_EXPORT(double, f64)
}
