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
// Only the lower triangle of H is read.
//
// Two variants; the launcher picks one by n (`dmc_chol_solve_variant`).
//
// Registers, n <= 28 (the main path: humanoid's n = 27). The tile N = 28
// >= n is a compile-time constant; rows and columns n..N-1 are the
// identity's, so no loop tests n. One system lives in a
// segment of S lanes (32 / S systems a warp; every shuffle has width S).
// P <= S lanes own rows, R rows each (N = P R): row i sits on lane i % P
// in slot i / P, as registers r[slot][0..N) indexed by compile-time
// constants only. Pivot step j broadcasts the diagonal from the owner of
// row j; rows below scale their element j; the rank-1 update walks
// k > j with one shuffle (l_kj from the owner of row k) and one FFMA per
// slot that holds a row >= k. The owner of row j keeps the broadcast l_kj
// in r[slot][k > j], so after the factor each lane holds the rows and the
// columns of L it needs: both substitutions are column-oriented, one
// shuffle and a few FFMAs per unknown, with no reduction, no shared
// memory and no __syncwarp. Several systems a warp matter because a
// shuffle serves every segment at once: with one system a warp (S = 32)
// the factor issues one shuffle per element of L, and the SM's shuffle
// rate bounds it. Float uses 8-lane segments (4 systems a warp) with 4
// rows a lane; double 16-lane segments with 2 rows a lane, so that a
// lane's R N values of L stay within 128 registers.
//   A block's systems are contiguous in H; the block stages them whole in
// shared memory with 16-byte cp.async copies, all in flight at once
// (scalar loads only for the ragged ends, so any element-aligned pointer
// works), then each lane reads the lower triangle of its rows from there.
// Skipping the chunks that hold only upper-triangle elements would cut
// the sectors of H read from 11.94 MB to 8.83 MB, but measured slower:
// the test per chunk costs more than the bytes it saves (PERF.md).
//   Bound at B = 4096, n = 27, float: bytes. The function needs the lower
// triangle of H, g and x, each once: 7.08 MB, 2.11 us at 3.35 TB/s. The
// work (about 16 kFLOP a system) is 0.98 us at 67 TFLOP/s. After the
// staging each warp runs its factor and solves as one dependent chain
// (28 pivot steps, each waiting for a shuffle and a square root); at
// B = 4096 there are only about 8 warps an SM, too few to hide that
// chain. Times in PERF.md.
//
// Shared memory, 29 <= n <= 64 (off the main path; the first version of
// this kernel). One warp per system; the scaled matrix lives in shared
// memory with a padded row stride n + 1, together with the scale and the
// right-hand side. Lane l owns rows l and l + 32. The pivot is read by
// every lane from shared memory, the rank-1 update runs row-parallel and
// both substitutions are column-oriented; __syncwarp() separates the
// dependent steps. It loads the whole matrix. Bound at n = 64, B = 4096,
// float: operations, about 0.19 MFLOP a system, 11.7 us at 67 TFLOP/s
// (the lower triangle, g and x are 36.2 MB, 10.8 us at 3.35 TB/s); it is
// limited by shared-memory instructions, about n^3/3 loads and stores a
// system.

#include <cuda_runtime.h>

#include <cstdint>

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
  __device__ __forceinline__ static float rroot(float x) { return rsqrtf(x); }
};

template <>
struct Traits<double> {
  __device__ __forceinline__ static double pivot_floor() { return 1e-12; }
  __device__ __forceinline__ static double root(double x) { return sqrt(x); }
  __device__ __forceinline__ static double rroot(double x) { return rsqrt(x); }
};

// The register tile N: segment width S, lanes that own rows P, rows a
// lane R (N = P R). Only N = 28 is built: humanoid's n = 27 is the one
// register-sized n on a ported path. A model with another n adds its tile
// here and in variant() below.
template <typename T, int N>
struct Tile;

template <>
struct Tile<float, 28> {
  static constexpr int kS = 8, kP = 7, kR = 4;
};

template <>
struct Tile<double, 28> {
  static constexpr int kS = 16, kP = 14, kR = 2;
};

template <typename T>
__device__ __forceinline__ T jacobi_scale(T d) {
  return d > T(1e-30) ? Traits<T>::rroot(d) : T(1);
}

// ---------------------------------------------------------------------------
// Register variant
// ---------------------------------------------------------------------------

// Copies src[0, count) into shared memory, element e to stage[shift + e]
// with shift = (src mod 16 bytes) / sizeof(T), so that 16-byte aligned
// addresses of src land on 16-byte aligned addresses of stage. The middle
// goes in 16-byte asynchronous copies (cp.async), all in flight at once,
// the ragged ends in scalar loads. Returns shift; the caller waits with
// __syncthreads().
template <typename T>
__device__ __forceinline__ int stage_contiguous(const T* __restrict__ src,
                                                int count, T* stage) {
  constexpr int kV = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  const int shift = static_cast<int>((addr & 15) / sizeof(T));
  const char* base = reinterpret_cast<const char*>(addr - (addr & 15));
  const int total = shift + count;  // stage[shift, total) is filled
  const int first_vec = shift ? 1 : 0;
  const int nvec = total / kV;
  if (shift) {
    for (int t = shift + threadIdx.x; t < kV && t < total; t += blockDim.x)
      stage[t] = src[t - shift];
  }
  const unsigned stage_addr =
      static_cast<unsigned>(__cvta_generic_to_shared(stage));
  for (int q = first_vec + threadIdx.x; q < nvec; q += blockDim.x) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     stage_addr + 16 * q),
                 "l"(base + 16 * static_cast<size_t>(q)));
  }
  const int tail = (nvec > first_vec ? nvec : first_vec) * kV;
  for (int t = tail + threadIdx.x; t < total; t += blockDim.x)
    stage[t] = src[t - shift];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  return shift;
}

// One system per segment of S lanes. Lanes P..S-1 of a segment own no
// row; their registers stay zero and no lane reads them.
template <typename T, int N>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
chol_solve_reg_kernel(const T* __restrict__ H, const T* __restrict__ g,
                      T* __restrict__ x, int batch, int n) {
  constexpr int S = Tile<T, N>::kS, P = Tile<T, N>::kP, R = Tile<T, N>::kR;
  constexpr int kPerWarp = 32 / S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int sl = lane % S;  // lane within the segment
  const int warp = threadIdx.x >> 5;
  const int per_block = (blockDim.x >> 5) * kPerWarp;
  const long long first = static_cast<long long>(blockIdx.x) * per_block;
  const int nsys = static_cast<int>(
      batch - first < per_block ? batch - first : per_block);
  const int nn = n * n;
  const int shift = stage_contiguous(H + first * nn, nsys * nn, stage);
  __syncthreads();
  if (warp * kPerWarp >= nsys) return;  // the whole warp, after the barrier

  // a segment past the batch's end works on system 0's copy and stores
  // nothing: the shuffles need every lane of the warp
  const int local = warp * kPerWarp + lane / S;
  const bool live = local < nsys;
  const T* A = stage + shift + (live ? local : 0) * nn;
  const long long b = first + local;
  const bool own = sl < P;

  // r[q][k], k <= row: the lower triangle of row q P + sl; r[q][k > row]
  // is written before it is read, at pivot step `row`. Rows and columns
  // n..N-1 are the identity's, so every loop below runs to the
  // compile-time N without a test on n.
  T r[R][N], s[R], v[R], rinv[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int row = q * P + sl;
    const bool real = own && row < n;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      r[q][k] = own && row == k ? T(1) : T(0);
      if (real && k <= row) r[q][k] = A[row * n + k];
    }
    s[q] = jacobi_scale(real ? A[row * (n + 1)] : T(1));
    v[q] = real && live ? g[b * n + row] * s[q] : T(0);
    rinv[q] = T(1);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const T sk = __shfl_sync(0xffffffffu, s[k / P], k % P, S);
#pragma unroll
    for (int q = 0; q < R; ++q) r[q][k] = r[q][k] * s[q] * sk;
  }

  // right-looking Cholesky; rinv[q] = 1 / L_ii of row q P + sl
  const T floor_ = Traits<T>::pivot_floor();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int qj = j / P;
    const T c = __shfl_sync(0xffffffffu, r[qj][j], j % P, S);
    const T p = c > floor_ ? c : floor_;
    const T inv = Traits<T>::rroot(p);
    T m[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int row = q * P + sl;
      if (q >= qj) {
        if (own && row == j) {
          r[q][j] = p * inv;
          rinv[q] = inv;
        } else if (row > j) {
          r[q][j] *= inv;
        }
      }
      // finished rows (row <= j) hold columns of L: m = 0 leaves them
      m[q] = q >= qj && row > j ? r[q][j] : T(0);
    }
#pragma unroll
    for (int k = j + 1; k < N; ++k) {
      // l_kj from the owner of row k; the owner of row j keeps it as
      // column j
      const T l = __shfl_sync(0xffffffffu, r[k / P][j], k % P, S);
#pragma unroll
      for (int q = qj; q < R; ++q) {
        if (q == qj) {
          r[q][k] = own && sl == j % P ? l : r[q][k] - m[q] * l;
        } else if (q * P + P - 1 >= k) {  // slots with a row >= k
          r[q][k] -= m[q] * l;
        }
      }
    }
  }

  // forward substitution L y = v: row i > j needs L_ij, its r[q][j]
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int qj = j / P;
    const T y = __shfl_sync(0xffffffffu, v[qj] * rinv[qj], j % P, S);
#pragma unroll
    for (int q = qj; q < R; ++q) {
      const int row = q * P + sl;
      v[q] = own && row == j ? y : (row > j ? v[q] - r[q][j] * y : v[q]);
    }
  }
  // back substitution L^T z = y: row k < i needs L_ik, its r[q][i]
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    const int qi = i / P;
    const T z = __shfl_sync(0xffffffffu, v[qi] * rinv[qi], i % P, S);
#pragma unroll
    for (int q = 0; q <= qi; ++q) {
      const int row = q * P + sl;
      v[q] = own && row == i ? z : (row < i ? v[q] - r[q][i] * z : v[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int row = q * P + sl;
    if (live && own && row < n) x[b * n + row] = v[q] * s[q];
  }
}

template <typename T, int N>
int launch_reg(const T* H, const T* g, T* x, int batch, int n,
               cudaStream_t stream) {
  constexpr int kPerWarp = 32 / Tile<T, N>::kS;
  const size_t per_warp = static_cast<size_t>(kPerWarp) * n * n * sizeof(T);
  int warps = kMaxWarpsPerBlock;
  while (warps > 1 && warps * per_warp + 16 > kSharedBudget) --warps;
  const int per_block = warps * kPerWarp;
  const int blocks = (batch + per_block - 1) / per_block;
  chol_solve_reg_kernel<T, N>
      <<<blocks, warps * 32, warps * per_warp + 16, stream>>>(H, g, x, batch,
                                                               n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Shared-memory variant
// ---------------------------------------------------------------------------

// elements of shared memory per system: A (n x (n + 1)), s and v
__host__ __device__ inline int per_warp_elems(int n) {
  return n * (n + 1) + 2 * n;
}

template <typename T>
__global__ void chol_solve_smem_kernel(const T* __restrict__ H,
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
    const T si = jacobi_scale(A[i * ld + i]);
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
int launch_smem(const T* H, const T* g, T* x, int batch, int n,
                cudaStream_t stream) {
  const int per_warp = per_warp_elems(n) * static_cast<int>(sizeof(T));
  int warps = kSharedBudget / per_warp;
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  const int blocks = (batch + warps - 1) / warps;
  chol_solve_smem_kernel<T><<<blocks, warps * 32, warps * per_warp,
                              stream>>>(H, g, x, batch, n);
  return static_cast<int>(cudaGetLastError());
}

// register tile N of the register variant for n, or 0 for shared memory
int variant(int n) { return n <= 28 ? 28 : 0; }

template <typename T>
int launch(const void* H_, const void* g_, void* x_, int batch, int n,
           void* stream_) {
  if (n < 1 || n > kMaxN || batch < 0) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const T* H = static_cast<const T*>(H_);
  const T* g = static_cast<const T*>(g_);
  T* x = static_cast<T*>(x_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (variant(n) == 28) return launch_reg<T, 28>(H, g, x, batch, n, stream);
  return launch_smem<T>(H, g, x, batch, n, stream);
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

// The variant the launcher takes for n: the register tile N (28), or 0
// for the shared-memory variant.
extern "C" int dmc_chol_solve_variant(int n) { return variant(n); }
