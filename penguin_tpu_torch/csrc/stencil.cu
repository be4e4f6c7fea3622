// Variable-coefficient (2N+1)-point stencil matvecs for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of penguin_tpu/pallas_kernels/stencil.py:
//   stencil5_matvec (body _kernel)  -> stencil5_matvec below (2D, 5 points)
//   stencil7_matvec (body _kernel3) -> stencil7_matvec below (3D, 7 points)
//
//   y[i,j]   = cc x[i,j] + cxm x[i-1,j] + cxp x[i+1,j]
//                        + cym x[i,j-1] + cyp x[i,j+1]
//   y[i,j,k] = ... + czm x[i,j,k-1] + czp x[i,j,k+1]
//
// Neighbours outside the array read 0 (no wrap).  All arrays are C-contiguous
// with the same extents and element type (float or double).
//
// What bounds it: each output reads 2N+2 values and writes one, with 2N+1
// multiply-adds, so the kernel is bound by memory traffic (at 1025^2 f32,
// 7 x 4 B x 1,050,625 = 29.4 MB per call), far below the card's arithmetic
// rate.  Design: one thread per output element; threadIdx.x runs along the
// contiguous last axis so every coefficient load and the store coalesce; the
// neighbour loads of x are masked at the array edges, which gives the zero
// boundary for any extents (no tile alignment, no padding).  The x
// neighbours re-read by adjacent threads are served by L1/L2.  Shared-memory
// tiles, vector loads and TMA are left for later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <typename T>
__global__ void stencil5_kernel(const T* __restrict__ cc,
                                const T* __restrict__ cxm,
                                const T* __restrict__ cxp,
                                const T* __restrict__ cym,
                                const T* __restrict__ cyp,
                                const T* __restrict__ x,
                                T* __restrict__ y, int64_t M, int64_t N) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kBlockX + threadIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y;
  if (i >= M || j >= N) return;
  const int64_t k = i * N + j;
  const T zero = T(0);
  const T xm = i > 0 ? x[k - N] : zero;
  const T xp = i < M - 1 ? x[k + N] : zero;
  const T ym = j > 0 ? x[k - 1] : zero;
  const T yp = j < N - 1 ? x[k + 1] : zero;
  y[k] = cc[k] * x[k] + cxm[k] * xm + cxp[k] * xp + cym[k] * ym + cyp[k] * yp;
}

template <typename T>
__global__ void stencil7_kernel(const T* __restrict__ cc,
                                const T* __restrict__ cxm,
                                const T* __restrict__ cxp,
                                const T* __restrict__ cym,
                                const T* __restrict__ cyp,
                                const T* __restrict__ czm,
                                const T* __restrict__ czp,
                                const T* __restrict__ x,
                                T* __restrict__ y, int64_t X, int64_t Y,
                                int64_t Z) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kBlockX + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y;
  const int64_t i = blockIdx.z;
  if (j >= Y || k >= Z) return;
  const int64_t plane = Y * Z;
  const int64_t o = (i * Y + j) * Z + k;
  const T zero = T(0);
  const T xm = i > 0 ? x[o - plane] : zero;
  const T xp = i < X - 1 ? x[o + plane] : zero;
  const T ym = j > 0 ? x[o - Z] : zero;
  const T yp = j < Y - 1 ? x[o + Z] : zero;
  const T zm = k > 0 ? x[o - 1] : zero;
  const T zp = k < Z - 1 ? x[o + 1] : zero;
  y[o] = cc[o] * x[o] + cxm[o] * xm + cxp[o] * xp + cym[o] * ym +
         cyp[o] * yp + czm[o] * zm + czp[o] * zp;
}

template <typename T>
cudaError_t launch5(const void* cc, const void* cxm, const void* cxp,
                    const void* cym, const void* cyp, const void* x, void* y,
                    int64_t M, int64_t N, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid(static_cast<unsigned>((N + kBlockX - 1) / kBlockX),
                  static_cast<unsigned>((M + kBlockY - 1) / kBlockY));
  stencil5_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(cc), static_cast<const T*>(cxm),
      static_cast<const T*>(cxp), static_cast<const T*>(cym),
      static_cast<const T*>(cyp), static_cast<const T*>(x),
      static_cast<T*>(y), M, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch7(const void* cc, const void* cxm, const void* cxp,
                    const void* cym, const void* cyp, const void* czm,
                    const void* czp, const void* x, void* y, int64_t X,
                    int64_t Y, int64_t Z, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid(static_cast<unsigned>((Z + kBlockX - 1) / kBlockX),
                  static_cast<unsigned>((Y + kBlockY - 1) / kBlockY),
                  static_cast<unsigned>(X));
  stencil7_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(cc), static_cast<const T*>(cxm),
      static_cast<const T*>(cxp), static_cast<const T*>(cym),
      static_cast<const T*>(cyp), static_cast<const T*>(czm),
      static_cast<const T*>(czp), static_cast<const T*>(x),
      static_cast<T*>(y), X, Y, Z);
  return cudaGetLastError();
}

}  // namespace

// elem_bytes selects the element type: 4 = float, 8 = double.  Returns a
// cudaError_t value (0 on success); launches nothing for an empty array.
extern "C" int stencil5_matvec(const void* cc, const void* cxm,
                               const void* cxp, const void* cym,
                               const void* cyp, const void* x, void* y,
                               int64_t M, int64_t N, int64_t elem_bytes,
                               void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (M > (int64_t{65535} * kBlockY)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return launch5<float>(cc, cxm, cxp, cym, cyp, x, y, M, N, s);
  if (elem_bytes == 8) return launch5<double>(cc, cxm, cxp, cym, cyp, x, y, M, N, s);
  return cudaErrorInvalidValue;
}

extern "C" int stencil7_matvec(const void* cc, const void* cxm,
                               const void* cxp, const void* cym,
                               const void* cyp, const void* czm,
                               const void* czp, const void* x, void* y,
                               int64_t X, int64_t Y, int64_t Z,
                               int64_t elem_bytes, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return cudaSuccess;
  if (X > 65535 || Y > (int64_t{65535} * kBlockY)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch7<float>(cc, cxm, cxp, cym, cyp, czm, czp, x, y, X, Y, Z, s);
  if (elem_bytes == 8)
    return launch7<double>(cc, cxm, cxp, cym, cyp, czm, czp, x, y, X, Y, Z, s);
  return cudaErrorInvalidValue;
}
