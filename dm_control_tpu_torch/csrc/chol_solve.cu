// Batched small SPD solve H x = g for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_chol_solve_kernel` and its wrapper
// `_chol_solve_tpu` (dm_control_tpu/ops/pallas_kernels.py:40-144). The
// physics step calls it once for the smooth acceleration, once per Newton
// iteration of the constraint solver and once in the Euler integrator.
//
// What it computes, per system (the same function as the plain PyTorch
// version `chol_solve_plain` in ops/linalg.py):
//   s_i = 1/sqrt(H_ii) where H_ii > 1e-30, else 1     (Jacobi scaling)
//   A = diag(s) H diag(s), v = s * g
//   right-looking Cholesky A = L L^T with L_jj = sqrt(max(a_jj, floor)),
//     floor 1e-6 for float and 1e-12 for double
//   forward substitution L y = v, back substitution L^T z = y, x = s * z
//
// What bounds it on the H100: latency, not bandwidth or FLOPs. A system at
// n = 27 (humanoid) is 2.9 KB of float input and about n^3/3 = 6.6k
// multiply-adds, but the factorization is a chain of n dependent steps,
// and each substitution another n. With B = 4096 systems the whole input
// is 12 MB, read once.
//
// Design: one warp per system, several warps per block. The scaled matrix
// lives in shared memory with a padded row stride n + 1 (no bank conflicts
// when lanes walk a column), together with the scale and the right-hand
// side: (n (n + 1) + 2 n) elements per warp, 3.2 KB at n = 27 in float and
// 17 KB at n = 64. Lane l owns rows l and l + 32, so n <= 64. Column j's
// pivot is read by every lane from shared memory (a broadcast), the rank-1
// update of the trailing rows runs row-parallel, and both substitutions
// are column-oriented (no reductions): after each unknown is known, every
// lane updates its own rows of the right-hand side. __syncwarp() separates
// the dependent phases. The input is read in its natural contiguous
// (B, n, n) layout, coalesced within each warp; nothing is padded.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kSharedBudget = 48 * 1024;  // no opt-in attribute needed

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  __device__ __forceinline__ static float pivot_floor() { return 1e-6f; }
  __device__ __forceinline__ static float root(float x) { return sqrtf(x); }
};

template <>
struct Traits<double> {
  __device__ __forceinline__ static double pivot_floor() { return 1e-12; }
  __device__ __forceinline__ static double root(double x) { return sqrt(x); }
};

// elements of shared memory per system: A (n x (n + 1)), s and v
__host__ __device__ inline int per_warp_elems(int n) {
  return n * (n + 1) + 2 * n;
}

template <typename T>
__global__ void chol_solve_kernel(const T* __restrict__ H,
                                  const T* __restrict__ g,
                                  T* __restrict__ x, int batch, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  if (b >= batch) return;  // whole warp leaves together

  const int ld = n + 1;
  T* A = smem + static_cast<size_t>(warp) * per_warp_elems(n);
  T* s = A + n * ld;
  T* v = s + n;
  const T* Hb = H + b * n * n;
  const T* gb = g + b * n;

  for (int idx = lane; idx < n * n; idx += 32) {
    const int i = idx / n;
    const int j = idx - i * n;
    A[i * ld + j] = Hb[idx];
  }
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    const T d = A[i * ld + i];
    const T si = d > T(1e-30) ? T(1) / Traits<T>::root(d) : T(1);
    s[i] = si;
    v[i] = gb[i] * si;
  }
  __syncwarp();
  for (int idx = lane; idx < n * n; idx += 32) {
    const int i = idx / n;
    const int j = idx - i * n;
    A[i * ld + j] = A[i * ld + j] * s[i] * s[j];
  }
  __syncwarp();

  // right-looking Cholesky, L overwrites the lower triangle
  const T floor_ = Traits<T>::pivot_floor();
  for (int j = 0; j < n; ++j) {
    const T a = A[j * ld + j];
    const T djj = Traits<T>::root(a > floor_ ? a : floor_);
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) A[i * ld + j] /= djj;
    if (lane == 0) A[j * ld + j] = djj;
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) {
      const T lij = A[i * ld + j];
      for (int k = j + 1; k <= i; ++k) A[i * ld + k] -= lij * A[k * ld + j];
    }
    __syncwarp();
  }

  // forward substitution: L y = v (y overwrites v)
  for (int i = 0; i < n; ++i) {
    const T yi = v[i] / A[i * ld + i];
    __syncwarp();
    if (lane == 0) v[i] = yi;
    for (int k = i + 1 + lane; k < n; k += 32) v[k] -= A[k * ld + i] * yi;
    __syncwarp();
  }
  // back substitution: L^T z = y (z overwrites v)
  for (int i = n - 1; i >= 0; --i) {
    const T zi = v[i] / A[i * ld + i];
    __syncwarp();
    if (lane == 0) v[i] = zi;
    for (int k = lane; k < i; k += 32) v[k] -= A[i * ld + k] * zi;
    __syncwarp();
  }
  for (int i = lane; i < n; i += 32) x[b * n + i] = v[i] * s[i];
}

template <typename T>
int launch(const void* H, const void* g, void* x, int batch, int n,
           void* stream) {
  if (n < 1 || n > kMaxN || batch < 0) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const int per_warp = per_warp_elems(n) * static_cast<int>(sizeof(T));
  int warps = kSharedBudget / per_warp;
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  if (warps < 1) warps = 1;
  const int blocks = (batch + warps - 1) / warps;
  chol_solve_kernel<T><<<blocks, warps * 32, warps * per_warp,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(H), static_cast<const T*>(g),
      static_cast<T*>(x), batch, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dmc_chol_solve_f32(const void* H, const void* g, void* x,
                                  int batch, int n, void* stream) {
  return launch<float>(H, g, x, batch, n, stream);
}

extern "C" int dmc_chol_solve_f64(const void* H, const void* g, void* x,
                                  int batch, int n, void* stream) {
  return launch<double>(H, g, x, batch, n, stream);
}
