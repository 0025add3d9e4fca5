// The fully-connected (FCC) lattice's per-lattice kernels, log domain, one
// batch element per thread block, one thread per label:
//   K3  fcc_fwd   the alpha chain (t ascending) and the beta chain
//                 (t descending) in one loop;
//   K4  fcc_beta  the beta chain alone (the score-only primal), the same
//                 template with the alpha chain compiled out;
//   K5  fcc_bwd   the emission posteriors and the per-element transition
//                 partials, then fcc_dtrans sums the partials in a fixed
//                 order.
//
// Replaces: torch_asg_tpu/ops/pallas/fcc_kernels.py::_fwd_kernel (launched
// by _run_fwd), ::_beta_kernel (_run_beta) and ::_bwd_kernel (_run_bwd).
// Their outputs are the contract; their TPU devices (TIME_BLOCK steps per
// grid iteration, 128-lane and 8-sublane padding, the ib_top carry, one
// (B, N) x (N, N) MXU product a step) do not carry over.
//
// What they compute, for element b with L = L_in[b], E = exp(T - c)
// (e[j*N + i] = exp(T[j][i] - c)) and lse(x, M)[i] = m + log(sum_j
// exp(x[j] - m) M[j][i]) + c, m the row max (0 on an all--inf row):
//   alpha_0 = I_0,  alpha_t = I_t + lse(alpha_{t-1}, E^T)      t < min(L, T)
//   beta_{L-1} = 0, beta_t = lse(I_{t+1} + beta_{t+1}, E)      t < L - 1
// and -inf on every other row; an element with L outside [1, T] has no
// beta at all (it scores -inf), and no alpha when L < 1.
//   K5, walking t = 0 .. min(L, T) - 1:
//     dI_t = softmax(alpha_t + beta_t) * g[b]   (zeros on an all--inf row)
//     acc[i][j] += u_t[i] v_t[j],   v_t = exp(alpha_{t-1} - m_{t-1})
//       u_t = dI_t * exp(where(alpha_t finite, I_t - alpha_t, -inf)
//                        + m_{t-1} + c)                        (t >= 1)
//   and dT = (sum over b of acc_b) * E.  dI rows t >= min(L, T) are 0.
//
// What bounds them on an H100: the serial chain.  Each element takes about
// L dependent steps; the bytes (each row read and written once) and the
// operations (an N-term dot per label and chain a step) are far below what
// the card moves and computes in that time, so the time is (steps) x
// (latency of one step).  The design keeps a step short:
//   - one block per element, so elements run side by side on separate SMs
//     and each block walks only its own steps;
//   - K3 runs both chains on the same threads, so their independent work
//     overlaps and one step costs two barriers for both chains: the two
//     row maxima in one reduction, then the exchange of the two exp rows;
//   - E sits in shared memory when it fits (fp32 N <= 238, fp64 N <= 168),
//     one copy with an odd row stride: beta reads a column (consecutive
//     threads, consecutive words) and alpha a row (an odd stride, so no
//     two threads of a warp share a bank).  Past that both chains read
//     global memory, where E stays in L2, beta from E and alpha from E^T,
//     so both reads are coalesced;
//   - the next step's emission rows are loaded into registers one step
//     ahead;
//   - K5 needs no E in its walk: the previous alpha row, exponentiated
//     against its max, goes through shared memory; thread i owns row i of
//     the transition accumulator (shared memory when N*N fits, else the
//     (B, N, N) scratch), so the rank-one update needs no synchronisation
//     and no atomics.  A second kernel sums the partials over b in order,
//     so two runs give the same bits.

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 16;  // 512 threads: the tier's width cap
constexpr size_t kSmemLimit = 227 * 1024;

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }

template <typename T>
__device__ __forceinline__ T neg_inf() { return static_cast<T>(-INFINITY); }

template <typename T>
__device__ __forceinline__ bool is_finite(T x) {
  return x > neg_inf<T>() && x < static_cast<T>(INFINITY);
}

template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }

template <typename T>
__device__ __forceinline__ T finite_or_zero(T x) { return is_finite(x) ? x : T(0); }

// K maxima (kMax) or K sums over the block at once, one barrier; every
// thread gets the results.  ``red`` holds K * kMaxWarps slots, reused only
// after a later barrier.  The sums are taken in a fixed order.
template <typename T, int K, bool kMax>
__device__ __forceinline__ void block_reduce(T (&v)[K], T* red) {
  for (int o = 16; o > 0; o >>= 1) {
    for (int q = 0; q < K; ++q) {
      const T w = __shfl_xor_sync(0xffffffffu, v[q], o);
      v[q] = kMax ? vmax(v[q], w) : v[q] + w;
    }
  }
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    for (int q = 0; q < K; ++q) red[q * kMaxWarps + warp] = v[q];
  }
  __syncthreads();
  for (int q = 0; q < K; ++q) {
    T r = red[q * kMaxWarps];
    for (int w = 1; w < nwarps; ++w) {
      const T x = red[q * kMaxWarps + w];
      r = kMax ? vmax(r, x) : r + x;
    }
    v[q] = r;
  }
}

// Shared memory: pa[N] and pb[N] (the exp rows each chain contracts),
// red[2 * kMaxWarps], then E[N * ld] (ld = N | 1, odd) when it fits.
template <typename T, bool kAlpha>
__global__ void fcc_chains_kernel(
    const T* __restrict__ em,       // (T, B, N) emissions
    const T* __restrict__ e_glob,   // (N, N) e[j*N + i] = exp(T[j][i] - c)
    const T* __restrict__ et_glob,  // (N, N) E^T (alpha's global-memory path)
    const T* __restrict__ c_ptr,    // () the max finite transition
    const int* __restrict__ li,
    T* __restrict__ alpha_out,      // (T, B, N) when kAlpha, else unused
    T* __restrict__ beta_out,       // (T, B, N)
    int t_total, int batch, int n, int ld, int e_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* pa = reinterpret_cast<T*>(smem_raw);
  T* pb = pa + n;
  T* red = pb + n;
  T* e_sm = red + 2 * kMaxWarps;

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int L = li[b];
  const int la = L < 0 ? 0 : (L > t_total ? t_total : L);  // alpha's live rows
  const int lb = (L >= 1 && L <= t_total) ? L : 0;          // beta's live rows
  const bool lab = k < n;
  const T ninf = neg_inf<T>();

  if (lab) {
    if constexpr (kAlpha) {
      for (int t = la; t < t_total; ++t) alpha_out[((size_t)t * batch + b) * n + k] = ninf;
    }
    for (int t = lb; t < t_total; ++t) beta_out[((size_t)t * batch + b) * n + k] = ninf;
  }
  const int steps = kAlpha ? la : lb;  // la >= lb
  if (steps == 0) return;              // the same for the whole block

  const T c = *c_ptr;
  if (e_in_smem) {
    for (int idx = k; idx < n * n; idx += blockDim.x) {
      const int j = idx / n;
      e_sm[j * ld + (idx - j * n)] = e_glob[idx];
    }
  }
  __syncthreads();

  // step 0: alpha_0 = I_0; beta seeded 0 at t = L - 1
  T a = ninf, bv = ninf;
  if constexpr (kAlpha) {
    if (lab) {
      a = em[(size_t)b * n + k];
      alpha_out[(size_t)b * n + k] = a;
    }
  }
  if (lb > 0) {
    bv = T(0);
    if (lab) beta_out[((size_t)(lb - 1) * batch + b) * n + k] = bv;
  }
  // the emissions step 1 consumes: I_1 (alpha), I_{L-1} (beta)
  T ia = (kAlpha && 1 < la && lab) ? em[((size_t)1 * batch + b) * n + k] : ninf;
  T ib = (1 < lb && lab) ? em[((size_t)(lb - 1) * batch + b) * n + k] : ninf;

  for (int s = 1; s < steps; ++s) {
    const bool do_b = s < lb;
    const int ta = s;
    const int tb = lb - 1 - s;
    // prefetch step s + 1's rows
    const T ia_n = (kAlpha && s + 1 < la && lab) ? em[((size_t)(s + 1) * batch + b) * n + k] : ninf;
    const T ib_n = (s + 1 < lb && lab) ? em[((size_t)(lb - 1 - s) * batch + b) * n + k] : ninf;

    const T xb = lab ? ib + bv : ninf;
    T mx[2] = {kAlpha && lab ? a : ninf, xb};
    block_reduce<T, 2, true>(mx, red);  // barrier 1
    const T ma = finite_or_zero(mx[0]);
    const T mb = finite_or_zero(mx[1]);
    if (lab) {
      if constexpr (kAlpha) pa[k] = d_exp(a - ma);
      pb[k] = d_exp(xb - mb);
    }
    __syncthreads();  // barrier 2

    if (lab) {
      if constexpr (kAlpha) {
        T acc = T(0);
        if (e_in_smem) {
          const T* row = e_sm + (size_t)k * ld;
          for (int j = 0; j < n; ++j) acc += pa[j] * row[j];
        } else {
          for (int j = 0; j < n; ++j) acc += pa[j] * et_glob[(size_t)j * n + k];
        }
        a = ia + ((ma + d_log(acc)) + c);
        alpha_out[((size_t)ta * batch + b) * n + k] = a;
      }
      if (do_b) {
        T acc = T(0);
        if (e_in_smem) {
          for (int j = 0; j < n; ++j) acc += pb[j] * e_sm[j * ld + k];
        } else {
          for (int j = 0; j < n; ++j) acc += pb[j] * e_glob[(size_t)j * n + k];
        }
        bv = (mb + d_log(acc)) + c;
        beta_out[((size_t)tb * batch + b) * n + k] = bv;
      }
    }
    ia = ia_n;
    ib = ib_n;
  }
}

// Shared memory: v[N] (the previous alpha row, exp against its max),
// red[3 * kMaxWarps], then acc[N*N] when it fits.
template <typename T>
__global__ void fcc_bwd_kernel(
    const T* __restrict__ em,     // (T, B, N)
    const T* __restrict__ c_ptr,  // ()
    const int* __restrict__ li,
    const T* __restrict__ alpha,  // (T, B, N)
    const T* __restrict__ beta,   // (T, B, N)
    const T* __restrict__ g,      // (B,)
    T* __restrict__ gi_out,       // (T, B, N)
    T* __restrict__ part,         // (B, N, N): part[b][j*N + i] = acc_b[i][j]
    int t_total, int batch, int n, int acc_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* v = reinterpret_cast<T*>(smem_raw);
  T* red_max = v + n;
  T* red_sum = red_max + 2 * kMaxWarps;
  T* acc_sm = red_sum + kMaxWarps;

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int L = li[b];
  const int la = L < 0 ? 0 : (L > t_total ? t_total : L);
  const bool lab = k < n;
  const T ninf = neg_inf<T>();
  T* part_b = part + (size_t)b * n * n;
  T* acc = acc_in_smem ? acc_sm : part_b;
  // thread k owns acc[j*N + k] for every j: no other thread touches it
  if (lab) {
    for (int j = 0; j < n; ++j) acc[(size_t)j * n + k] = T(0);
    for (int t = la; t < t_total; ++t) gi_out[((size_t)t * batch + b) * n + k] = T(0);
  }
  const T c = *c_ptr;
  const T gs = g[b];

  T a_prev = ninf, mp = T(0);
  size_t row = (size_t)b;
  T a = (la > 0 && lab) ? alpha[row * n + k] : ninf;
  T bt = (la > 0 && lab) ? beta[row * n + k] : ninf;
  T it = (la > 0 && lab) ? em[row * n + k] : ninf;
  for (int t = 0; t < la; ++t) {
    const size_t row_n = (size_t)(t + 1) * batch + b;
    const bool more = t + 1 < la && lab;
    const T a_n = more ? alpha[row_n * n + k] : ninf;
    const T b_n = more ? beta[row_n * n + k] : ninf;
    const T i_n = more ? em[row_n * n + k] : ninf;

    const T gamma = lab ? a + bt : ninf;
    T mx[2] = {gamma, lab ? a : ninf};
    block_reduce<T, 2, true>(mx, red_max);  // barrier 1
    const T mg = finite_or_zero(mx[0]);
    // the previous row for this step's update; every thread has read the
    // last step's v before it reached barrier 1
    if (t > 0 && lab) v[k] = d_exp(a_prev - mp);
    const T eg = lab ? d_exp(gamma - mg) : T(0);
    T sm[1] = {eg};
    block_reduce<T, 1, false>(sm, red_sum);  // barrier 2
    const T gi = eg / (sm[0] == T(0) ? T(1) : sm[0]) * gs;
    row = (size_t)t * batch + b;
    if (lab) gi_out[row * n + k] = gi;

    if (t > 0 && lab) {
      const T u_expo = is_finite(a) ? it - a : ninf;
      const T u = gi * d_exp(u_expo + mp + c);
      for (int j = 0; j < n; ++j) acc[(size_t)j * n + k] += u * v[j];
    }
    a_prev = a;
    mp = finite_or_zero(mx[1]);
    a = a_n;
    bt = b_n;
    it = i_n;
  }
  if (acc_in_smem && lab) {
    for (int j = 0; j < n; ++j) part_b[(size_t)j * n + k] = acc[(size_t)j * n + k];
  }
}

// dT[i][j] = (sum over b, in order, of acc_b[i][j]) * E[i][j].
template <typename T>
__global__ void fcc_dtrans_kernel(const T* __restrict__ part,
                                  const T* __restrict__ e_glob,  // E[i*N + j]
                                  T* __restrict__ d_trans, int batch, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // idx = j*N + i
  if (idx >= n * n) return;
  T sum = T(0);
  for (int b = 0; b < batch; ++b) sum += part[(size_t)b * n * n + idx];
  const int j = idx / n;
  const int i = idx - j * n;
  d_trans[(size_t)i * n + j] = sum * e_glob[(size_t)i * n + j];
}

int block_threads(int n) { return ((n + 31) / 32) * 32; }

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, bool kAlpha>
int launch_chains(const T* em, const T* e, const T* e_t, const T* c, const int* li,
                  T* alpha_out, T* beta_out, int t_total, int batch, int n,
                  void* stream) {
  const int threads = block_threads(n);
  if (threads > kMaxWarps * 32) return (int)cudaErrorInvalidValue;
  const int ld = n | 1;
  const size_t base = sizeof(T) * (2 * (size_t)n + 2 * kMaxWarps);
  const size_t e_bytes = sizeof(T) * (size_t)n * ld;
  const int e_in_smem = base + e_bytes <= kSmemLimit;
  const size_t smem = base + (e_in_smem ? e_bytes : 0);
  cudaError_t err = set_smem((const void*)fcc_chains_kernel<T, kAlpha>, smem);
  if (err != cudaSuccess) return (int)err;
  fcc_chains_kernel<T, kAlpha><<<batch, threads, smem, (cudaStream_t)stream>>>(
      em, e, e_t, c, li, alpha_out, beta_out, t_total, batch, n, ld, e_in_smem);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const T* em, const T* e, const T* c, const int* li, const T* alpha,
               const T* beta, const T* g, T* gi_out, T* part, T* d_trans,
               int t_total, int batch, int n, void* stream) {
  const int threads = block_threads(n);
  if (threads > kMaxWarps * 32) return (int)cudaErrorInvalidValue;
  const size_t base = sizeof(T) * ((size_t)n + 3 * kMaxWarps);
  const size_t square = sizeof(T) * (size_t)n * n;
  const int acc_in_smem = base + square <= kSmemLimit;
  const size_t smem = base + (acc_in_smem ? square : 0);
  cudaError_t err = set_smem((const void*)fcc_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  fcc_bwd_kernel<T><<<batch, threads, smem, st>>>(em, c, li, alpha, beta, g, gi_out,
                                                  part, t_total, batch, n, acc_in_smem);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cells = n * n;
  fcc_dtrans_kernel<T><<<(cells + 255) / 256, 256, 0, st>>>(part, e, d_trans, batch, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fcc_fwd_f32(const float* em, const float* e, const float* e_t, const float* c,
                const int* li, float* alpha, float* beta, int t_total, int batch,
                int n, void* stream) {
  return launch_chains<float, true>(em, e, e_t, c, li, alpha, beta, t_total, batch, n,
                                    stream);
}

int fcc_fwd_f64(const double* em, const double* e, const double* e_t, const double* c,
                const int* li, double* alpha, double* beta, int t_total, int batch,
                int n, void* stream) {
  return launch_chains<double, true>(em, e, e_t, c, li, alpha, beta, t_total, batch, n,
                                     stream);
}

int fcc_beta_f32(const float* em, const float* e, const float* c, const int* li,
                 float* beta, int t_total, int batch, int n, void* stream) {
  return launch_chains<float, false>(em, e, nullptr, c, li, nullptr, beta, t_total,
                                     batch, n, stream);
}

int fcc_beta_f64(const double* em, const double* e, const double* c, const int* li,
                 double* beta, int t_total, int batch, int n, void* stream) {
  return launch_chains<double, false>(em, e, nullptr, c, li, nullptr, beta, t_total,
                                      batch, n, stream);
}

int fcc_bwd_f32(const float* em, const float* e, const float* c, const int* li,
                const float* alpha, const float* beta, const float* g, float* gi,
                float* part, float* d_trans, int t_total, int batch, int n,
                void* stream) {
  return launch_bwd<float>(em, e, c, li, alpha, beta, g, gi, part, d_trans, t_total,
                           batch, n, stream);
}

int fcc_bwd_f64(const double* em, const double* e, const double* c, const int* li,
                const double* alpha, const double* beta, const double* g, double* gi,
                double* part, double* d_trans, int t_total, int batch, int n,
                void* stream) {
  return launch_bwd<double>(em, e, c, li, alpha, beta, g, gi, part, d_trans, t_total,
                            batch, n, stream);
}

}  // extern "C"
