// The force-aligned (FAC) lattice's per-lattice kernels, log domain, one
// batch element per thread block, one thread per target slot:
//   K6  fac_alpha  the alpha chain, t ascending over every frame;
//   K7  fac_beta   the beta chain, t descending from the element's seed;
//   K8  fac_bwd    the aligned posteriors and the summed edge fractions.
//
// Replaces: torch_asg_tpu/ops/pallas/fac_kernels.py::_fac_alpha_kernel
// (launched by _fac_alpha_pass), ::_fac_beta_kernel (_fac_beta_pass) and
// ::_fac_bwd_kernel (_fac_bwd_pass).  Their outputs are the contract; their
// TPU devices (one grid step a frame, 128-lane and 8-sublane padding, the
// lane rotations of _shift_right and _shift_left) do not carry over.
//
// What they compute, for element b, with A the gathered emissions (-inf
// outside t < L_in and s < L_out, so K6 needs no lengths), L = L_in[b],
// Lo = L_out[b]:
//   K6: alpha_0[s] = A_0[0] at s = 0, -inf elsewhere;
//       alpha_t[s] = A_t[s] + logaddexp(alpha_{t-1}[s] + self[s],
//                                       alpha_{t-1}[s-1] + next[s-1])
//   K7: beta_{L-1}[s] = 0 at s = Lo - 1, -inf elsewhere;
//       beta_t[s] = logaddexp(self[s] + x[s], next[s] + x[s+1]),
//       x = A_{t+1} + beta_{t+1}, x[S] = -inf, for t < L - 1;
//       -inf on every row t >= L, and on every row when L is outside [1, T]
//       (A is -inf past L, so this is the recursion's own value there).
//   K8, for every frame t:
//       dA_t = softmax(alpha_t + beta_t) * g[b]     (zeros on an all--inf row)
//     and for t >= 1, with sub = A_t - alpha_t (-inf where alpha_t = -inf):
//       gself[s] += dA_t[s] * (s == 0 ? 1 : exp(alpha_{t-1}[s] + self[s] + sub))
//       gdiag[s] += dA_t[s] * exp(alpha_{t-1}[s-1] + next[s-1] + sub)
//     (exponents <= 0), and gnext[s] = gdiag[s+1], 0 at s = S-1.
//
// What bounds them on an H100: the serial chain.  Each element takes T (K6,
// K8) or L (K7) dependent steps of a few operations a slot; the bytes (each
// row read and written once) are far below what the card moves in that
// time, so the time is (steps) x (latency of one step).  The design keeps a
// step short:
//   - one block per element, so elements run side by side on separate SMs;
//   - K6 and K7 exchange the neighbouring slot's value through a shared
//     row with one barrier a step; the row is double-buffered, so a step's
//     writes never wait on the previous step's reads;
//   - K8 reads alpha_{t-1}[s-1] straight from memory (no exchange) and needs
//     two barriers a step, the row max and the row sum; each thread keeps
//     its slot's two edge sums in registers over t, so they are summed in a
//     fixed order with no second kernel and no atomics;
//   - the next step's rows are loaded into registers one step ahead.

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 16;  // 512 threads: the tier's width cap

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

// -inf-safe 2-way log-semiring sum: m + log(exp(a-m) + exp(b-m)).
template <typename T>
__device__ __forceinline__ T log_add(T a, T b) {
  T m = vmax(a, b);
  if (!is_finite(m)) return m;
  return m + d_log(d_exp(a - m) + d_exp(b - m));
}

// A max (kMax) or a sum over the block, one barrier; every thread gets the
// result.  ``red`` holds kMaxWarps slots, reused only after a later barrier.
// The sum is taken in a fixed order.
template <typename T, bool kMax>
__device__ __forceinline__ T block_reduce(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? vmax(v, w) : v + w;
  }
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < nwarps; ++w) r = kMax ? vmax(r, red[w]) : r + red[w];
  return r;
}

// Shared memory: y[2][S+1], y[buf][s+1] = alpha_{t-1}[s] + next[s], y[.][0] = -inf.
template <typename T>
__global__ void fac_alpha_kernel(const T* __restrict__ al,      // (T, B, S)
                                 const T* __restrict__ self_t,  // (B, S)
                                 const T* __restrict__ next_t,  // (B, S)
                                 T* __restrict__ alpha_out,     // (T, B, S)
                                 int t_total, int batch, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* y = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const bool slot = k < s;
  const T ninf = neg_inf<T>();
  if (k == 0) {
    y[0] = ninf;
    y[s + 1] = ninf;
  }
  const T self_k = slot ? self_t[(size_t)b * s + k] : T(0);
  const T next_k = slot ? next_t[(size_t)b * s + k] : T(0);

  T a = (k == 0) ? al[(size_t)b * s] : ninf;
  if (slot) alpha_out[(size_t)b * s + k] = a;
  T av = (1 < t_total && slot) ? al[((size_t)batch + b) * s + k] : ninf;
  for (int t = 1; t < t_total; ++t) {
    const T av_n = (t + 1 < t_total && slot) ? al[((size_t)(t + 1) * batch + b) * s + k] : ninf;
    T* yb = y + (t & 1) * (s + 1);
    if (slot) yb[k + 1] = a + next_k;
    __syncthreads();
    if (slot) {
      a = av + log_add(a + self_k, yb[k]);
      alpha_out[((size_t)t * batch + b) * s + k] = a;
    }
    av = av_n;
  }
}

// Shared memory: x[2][S+1], x[buf][s] = A_{t+1}[s] + beta_{t+1}[s], x[.][S] = -inf.
template <typename T>
__global__ void fac_beta_kernel(const T* __restrict__ al,      // (T, B, S)
                                const T* __restrict__ self_t,  // (B, S)
                                const T* __restrict__ next_t,  // (B, S)
                                const int* __restrict__ li, const int* __restrict__ lo,
                                T* __restrict__ beta_out,      // (T, B, S)
                                int t_total, int batch, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* x = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int L = li[b];
  const int lb = (L >= 1 && L <= t_total) ? L : 0;
  const bool slot = k < s;
  const T ninf = neg_inf<T>();
  if (slot) {
    for (int t = lb; t < t_total; ++t) beta_out[((size_t)t * batch + b) * s + k] = ninf;
  }
  if (lb == 0) return;  // the same for the whole block
  if (k == 0) {
    x[s] = ninf;
    x[2 * s + 1] = ninf;
  }
  const T self_k = slot ? self_t[(size_t)b * s + k] : T(0);
  const T next_k = slot ? next_t[(size_t)b * s + k] : T(0);

  T bv = (k == lo[b] - 1) ? T(0) : ninf;
  if (slot) beta_out[((size_t)(lb - 1) * batch + b) * s + k] = bv;
  T av = (lb > 1 && slot) ? al[((size_t)(lb - 1) * batch + b) * s + k] : ninf;
  for (int t = lb - 2; t >= 0; --t) {
    const T av_n = (t > 0 && slot) ? al[((size_t)t * batch + b) * s + k] : ninf;
    T* xb = x + (t & 1) * (s + 1);
    const T xv = av + bv;
    if (slot) xb[k] = xv;
    __syncthreads();
    if (slot) {
      bv = log_add(self_k + xv, next_k + xb[k + 1]);
      beta_out[((size_t)t * batch + b) * s + k] = bv;
    }
    av = av_n;
  }
}

// Shared memory: red_max[kMaxWarps], red_sum[kMaxWarps], z[S+1] (the final
// shift of the diagonal sums).
template <typename T>
__global__ void fac_bwd_kernel(const T* __restrict__ al,      // (T, B, S)
                               const T* __restrict__ self_t,  // (B, S)
                               const T* __restrict__ next_t,  // (B, S)
                               const T* __restrict__ alpha,   // (T, B, S)
                               const T* __restrict__ beta,    // (T, B, S)
                               const T* __restrict__ g,       // (B,)
                               T* __restrict__ gi_out,        // (T, B, S)
                               T* __restrict__ gself, T* __restrict__ gnext,  // (B, S)
                               int t_total, int batch, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red_max = reinterpret_cast<T*>(smem_raw);
  T* red_sum = red_max + kMaxWarps;
  T* z = red_sum + kMaxWarps;
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const bool slot = k < s;
  const bool left = slot && k >= 1;  // slot s - 1 exists
  const T ninf = neg_inf<T>();
  const T self_k = slot ? self_t[(size_t)b * s + k] : T(0);
  const T next_l = left ? next_t[(size_t)b * s + k - 1] : T(0);
  const T gs = g[b];

  T acc_self = T(0), acc_diag = T(0);
  T a_prev = ninf, a_prev_l = ninf;
  size_t row = (size_t)b;
  T a = slot ? alpha[row * s + k] : ninf;
  T a_l = left ? alpha[row * s + k - 1] : ninf;
  T bt = slot ? beta[row * s + k] : ninf;
  T av = slot ? al[row * s + k] : ninf;
  for (int t = 0; t < t_total; ++t) {
    const size_t row_n = (size_t)(t + 1) * batch + b;
    const bool more = t + 1 < t_total;
    const T a_n = (more && slot) ? alpha[row_n * s + k] : ninf;
    const T a_l_n = (more && left) ? alpha[row_n * s + k - 1] : ninf;
    const T b_n = (more && slot) ? beta[row_n * s + k] : ninf;
    const T av_n = (more && slot) ? al[row_n * s + k] : ninf;

    const T gamma = slot ? a + bt : ninf;
    T m = block_reduce<T, true>(gamma, red_max);  // barrier 1
    m = is_finite(m) ? m : T(0);
    const T e = slot ? d_exp(gamma - m) : T(0);
    const T den = block_reduce<T, false>(e, red_sum);  // barrier 2
    const T gi = e / (den == T(0) ? T(1) : den) * gs;
    row = (size_t)t * batch + b;
    if (slot) gi_out[row * s + k] = gi;
    if (t > 0 && slot) {
      const T sub = is_finite(a) ? av - a : ninf;
      // slot 0 has only the self-loop in-edge, fraction 1
      const T hori = (k == 0) ? T(1) : d_exp(a_prev + self_k + sub);
      const T diag = d_exp((left ? a_prev_l + next_l : ninf) + sub);
      acc_self += gi * hori;
      acc_diag += gi * diag;
    }
    a_prev = a;
    a_prev_l = a_l;
    a = a_n;
    a_l = a_l_n;
    bt = b_n;
    av = av_n;
  }
  if (slot) z[k] = acc_diag;
  __syncthreads();
  if (slot) {
    gself[(size_t)b * s + k] = acc_self;
    gnext[(size_t)b * s + k] = (k + 1 < s) ? z[k + 1] : T(0);
  }
}

int block_threads(int s) { return ((s + 31) / 32) * 32; }

template <typename T>
int launch_alpha(const T* al, const T* self_t, const T* next_t, T* alpha, int t_total,
                 int batch, int s, void* stream) {
  const int threads = block_threads(s);
  if (threads > kMaxWarps * 32) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * 2 * ((size_t)s + 1);
  fac_alpha_kernel<T><<<batch, threads, smem, (cudaStream_t)stream>>>(
      al, self_t, next_t, alpha, t_total, batch, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_beta(const T* al, const T* self_t, const T* next_t, const int* li,
                const int* lo, T* beta, int t_total, int batch, int s, void* stream) {
  const int threads = block_threads(s);
  if (threads > kMaxWarps * 32) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * 2 * ((size_t)s + 1);
  fac_beta_kernel<T><<<batch, threads, smem, (cudaStream_t)stream>>>(
      al, self_t, next_t, li, lo, beta, t_total, batch, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const T* al, const T* self_t, const T* next_t, const T* alpha,
               const T* beta, const T* g, T* gi, T* gself, T* gnext, int t_total,
               int batch, int s, void* stream) {
  const int threads = block_threads(s);
  if (threads > kMaxWarps * 32) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * (2 * kMaxWarps + (size_t)s + 1);
  fac_bwd_kernel<T><<<batch, threads, smem, (cudaStream_t)stream>>>(
      al, self_t, next_t, alpha, beta, g, gi, gself, gnext, t_total, batch, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fac_alpha_f32(const float* al, const float* self_t, const float* next_t,
                  float* alpha, int t_total, int batch, int s, void* stream) {
  return launch_alpha<float>(al, self_t, next_t, alpha, t_total, batch, s, stream);
}

int fac_alpha_f64(const double* al, const double* self_t, const double* next_t,
                  double* alpha, int t_total, int batch, int s, void* stream) {
  return launch_alpha<double>(al, self_t, next_t, alpha, t_total, batch, s, stream);
}

int fac_beta_f32(const float* al, const float* self_t, const float* next_t,
                 const int* li, const int* lo, float* beta, int t_total, int batch,
                 int s, void* stream) {
  return launch_beta<float>(al, self_t, next_t, li, lo, beta, t_total, batch, s, stream);
}

int fac_beta_f64(const double* al, const double* self_t, const double* next_t,
                 const int* li, const int* lo, double* beta, int t_total, int batch,
                 int s, void* stream) {
  return launch_beta<double>(al, self_t, next_t, li, lo, beta, t_total, batch, s,
                             stream);
}

int fac_bwd_f32(const float* al, const float* self_t, const float* next_t,
                const float* alpha, const float* beta, const float* g, float* gi,
                float* gself, float* gnext, int t_total, int batch, int s,
                void* stream) {
  return launch_bwd<float>(al, self_t, next_t, alpha, beta, g, gi, gself, gnext,
                           t_total, batch, s, stream);
}

int fac_bwd_f64(const double* al, const double* self_t, const double* next_t,
                const double* alpha, const double* beta, const double* g, double* gi,
                double* gself, double* gnext, int t_total, int batch, int s,
                void* stream) {
  return launch_bwd<double>(al, self_t, next_t, alpha, beta, g, gi, gself, gnext,
                            t_total, batch, s, stream);
}

}  // extern "C"
