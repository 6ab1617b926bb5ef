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
// Block rows, 29 <= n <= 64 (humanoid_CMU's n = 62). N = 64 >= n is a
// compile-time constant; rows and columns n..N-1 are the identity's. One
// system a block of N threads, one row a thread: thread t keeps row t
// whole as r[0..N), indexed by compile-time constants only, its lower
// triangle as stored and its upper part by symmetry (read from the lower
// triangle's column t). No shuffle crosses warps, so pivot step j
// publishes column j through shared memory (one store a row, two
// alternating buffers, one barrier); every thread reads the pivot and the
// column as broadcast 16-byte loads and updates every column k > j of its
// row with one FMA (a_ik -= (a_ij / p) a_kj, one rsqrt a step). Updating
// the upper part too keeps the control flow uniform, and leaves row i's
// r[k > i] as the Schur complement c_ki at step i, L_ki L_ii: each thread
// ends with its row and its column of L, so the back substitution is
// column-oriented, one shuffle an unknown inside the warp that owns it
// and one barrier a warp to hand the warp's unknowns to the warps below.
// The forward substitution rides along the factor as the right-hand
// side's column. A block stages its system with the register tile's
// cp.async copies into room for N^2 elements, so that the load reads both
// candidate addresses of each element and keeps one without a branch.
//   Work at N = 64: 2,016 FMAs a row, 129 k a system: 3.2x the factor's
// n^3 / 6 multiply-adds at n = 62. Bound at B = 4096, n = 62: bytes (the
// lower triangle, g and x), 10.16 us in float and 20.32 us in double at
// 3.35 TB/s; the operations the function needs (n^3 / 3 + 4 n^2 a system)
// take 5.80 us at 67 TFLOP/s. ptxas: 127 registers in float, 176 in
// double, no spills; an SM holds 8 blocks (16 warps) in float and 4 (8
// warps) in double: 127 registers round to 128, 8 K a block of 64 threads,
// 8 blocks in the 64 K register file; 176 registers are 5.5 K a warp, 2
// warps in a scheduler's 16 K. Shared memory, 17.5 and 34.9 KB a block,
// does not bound either (the driver sizes the carveout itself). Measured
// on an H100 (PERF.md): 0.082 ms in float and 0.206 ms in double at (4096,
// 62), 12 % and 10 % of the bound. Its code is about 5.9 k (float) and
// 9.9 k (double) SASS instructions, FMAs 38 % and 25 % of them, run once
// by each warp; at those times a scheduler issues about half an
// instruction a cycle: the pivot chain of each step (barrier, load, rsqrt)
// is not hidden by 4 (double: 2) warps a scheduler. Tried and slower
// (PERF.md): two rows a thread in float (255 registers, with spills),
// warps that leave the factor once their rows are done, a barrier for each
// unknown of the back substitution, 4 x 16 register tiles a thread (fewer
// shared-memory loads, many more instructions) and split mbarrier
// arrive/wait to overlap each step's barrier with its update.

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
  __device__ __forceinline__ static float rroot(float x) { return rsqrtf(x); }
};

template <>
struct Traits<double> {
  __device__ __forceinline__ static double pivot_floor() { return 1e-12; }
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
// Block-row variant
// ---------------------------------------------------------------------------

// 16 bytes of shared memory (16-byte aligned) as V elements.
__device__ __forceinline__ void load16(const float* p, float (&e)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  e[0] = f.x;
  e[1] = f.y;
  e[2] = f.z;
  e[3] = f.w;
}

__device__ __forceinline__ void load16(const double* p, double (&e)[2]) {
  const double2 d = *reinterpret_cast<const double2*>(p);
  e[0] = d.x;
  e[1] = d.y;
}

// Elements of shared memory of a block of the block rows N: the staged
// system (room for N^2, so that every row and column address of the
// load is inside it, plus the shift of a misaligned source), the scale
// (N), the solution's blocks handed from warp to warp (N) and two column
// buffers (N + V each: a column, then the right-hand side).
template <typename T, int N>
__host__ __device__ constexpr int rows_smem_elems() {
  constexpr int V = 16 / sizeof(T);
  return N * N + V + 2 * N + 2 * (N + V);
}

// 1 / sqrt(x) for the block rows' pivots (x >= the floor, never
// subnormal): float takes the hardware's approximation without the
// subnormal scaling that rsqrtf adds.
__device__ __forceinline__ float pivot_rroot(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ double pivot_rroot(double x) { return rsqrt(x); }

// The block rows (the note at the top): one system per block of N threads,
// row t of the system in thread t's registers.
template <typename T, int N>
__global__ void __launch_bounds__(N)
chol_solve_rows_kernel(const T* __restrict__ H, const T* __restrict__ g,
                       T* __restrict__ x, int n) {
  constexpr int V = 16 / sizeof(T), kBuf = N + V, W = N / 32;
  static_assert(N % 32 == 0, "a system is whole warps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);
  T* sbuf = stage + N * N + V;
  T* zbuf = sbuf + N;
  T* cbuf = zbuf + N;
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const T* A = stage + stage_contiguous(H + b * n * n, n * n, stage);
  __syncthreads();

  // row t's element k: A[t n + k] below the diagonal, A[k n + t] above;
  // both addresses lie inside the stage for any t, k < N, so both are
  // read and one is kept, without a branch. For an identity row (t >= n)
  // and for the candidate not kept, the address may lie past the n^2
  // staged elements, in slots nothing wrote: those values are read and
  // thrown away.
  const bool real = t < n;
  T r[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const T lower = A[t * n + k], upper = A[k * n + t];
    r[k] = real && k < n ? (k <= t ? lower : upper) : T(t == k);
  }
  const T s = real ? jacobi_scale(A[t * (n + 1)]) : T(1);
  T v = real ? g[b * n + t] * s : T(0);
  T rinv = T(1);
  sbuf[t] = s;
  __syncthreads();
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += V) {
    T e[V];
    load16(sbuf + k0, e);
#pragma unroll
    for (int u = 0; u < V; ++u) r[k0 + u] = r[k0 + u] * s * e[u];
  }

  // right-looking Cholesky with the forward substitution
  const T floor_ = Traits<T>::pivot_floor();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T* c = cbuf + (j & 1) * kBuf;
    c[t] = r[j];
    if (t == j) c[N] = v;
    __syncthreads();
    const T piv = c[j];
    const T vj = c[N];
    const T p = piv > floor_ ? piv : floor_;
    const T inv = pivot_rroot(p);
    // a_ij / p below the pivot; the pivot's owner keeps L_jj
    const bool below = t > j;
    const T m = below ? r[j] * (inv * inv) : T(0);
    r[j] = t == j ? p * inv : (below ? r[j] * inv : r[j]);
    rinv = t == j ? inv : rinv;
    v -= m * vj;
#pragma unroll
    for (int k0 = (j + 1) / V * V; k0 < N; k0 += V) {
      T e[V];
      load16(c + k0, e);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (k0 + u > j) r[k0 + u] -= m * e[u];
      }
    }
  }

  // back substitution L^T z = y, y = v / L_ii: row k < i subtracts
  // L_ik z_i, its r[i] / L_kk; warp w owns unknowns 32 w..32 w + 31
  v *= rinv;
#pragma unroll
  for (int w = W - 1; w >= 0; --w) {
    if (warp == w) {
#pragma unroll
      for (int i = 32 * w + 31; i >= 32 * w; --i) {
        const T z = __shfl_sync(0xffffffffu, v * rinv, i & 31);
        const T left = v - r[i] * (rinv * z);
        v = t == i ? z : (t < i ? left : v);
      }
    }
    if (w > 0) {
      if (warp == w) zbuf[t] = v;
      __syncthreads();
      if (warp < w) {
#pragma unroll
        for (int i0 = 32 * w; i0 < 32 * w + 32; i0 += V) {
          T e[V];
          load16(zbuf + i0, e);
#pragma unroll
          for (int u = 0; u < V; ++u) v -= r[i0 + u] * (rinv * e[u]);
        }
      }
    }
  }
  if (real) x[b * n + t] = v * s;
}

template <typename T, int N>
int launch_rows(const T* H, const T* g, T* x, int batch, int n,
                cudaStream_t stream) {
  constexpr int kBytes = rows_smem_elems<T, N>() * sizeof(T);
  static_assert(kBytes <= 48 * 1024,
                "above 48 KB a block needs the dynamic shared-memory opt-in");
  chol_solve_rows_kernel<T, N><<<batch, N, kBytes, stream>>>(H, g, x, n);
  return static_cast<int>(cudaGetLastError());
}

// the variant's N for n: 28, the register tile; 64, the block rows
int variant(int n) { return n <= 28 ? 28 : 64; }

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
  return launch_rows<T, 64>(H, g, x, batch, n, stream);
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

// The variant the launcher takes for n, as its N: 28 for the register
// tile, 64 for the block rows.
extern "C" int dmc_chol_solve_variant(int n) { return variant(n); }

