// Fused ASG gradients: both alpha chains of one batch element per thread
// block, recomputed with t ascending from the beta residuals that the store
// variant of K1 (asg_fwd.cu) wrote, emitting every gradient in one pass
// (kernel K2).  A second kernel sums the per-element transition partials.
//
// Replaces: torch_asg_tpu/ops/pallas/asg_kernels.py::_bwd_kernel (launched
// by _run_bwd).  Its outputs are the contract; its TPU devices (time blocks
// of 8 steps, one (N, K*B) @ (K*B, N) MXU product per block, lane padding,
// wrap-rolls) do not carry over.
//
// What it computes, for element b with L = L_in[b], walking t = 0 .. L-1:
//   FCC alpha, exp domain, E = exp(T - c) (the wrapper passes E and E^T):
//     s_t = E-contraction of pa_{t-1} over source labels (s_0 = 1),
//     lpa_t = log s_t + I_t,   pa_t = exp(lpa_t - max lpa_t)
//     gI_t = softmax(lpa_t + log PB_t) * g_full[b]
//       (the posterior softmax in log space: pa * pb may underflow in fp32;
//       lpa differs from log pa_t by a per-row constant, which the softmax
//       cancels)
//     acc[i, j] += (gI_t[i] / s_t[i]) * pa_{t-1}[j]      (t >= 1)
//   FAC alpha, log domain, seeded at t = 0 on slot 0 only:
//     qa_t[s] = A_t[s] + logaddexp(qa_{t-1}[s] + self[s],
//                                  qa_{t-1}[s-1] + next[s-1])
//     gA_t = softmax(qa_t + QB_t) * g_fac[b]
//     for t >= 1, with sub = A_t - qa_t (or -inf where qa_t = -inf):
//       gself[s] += gA_t[s] * (s == 0 ? 1 : exp(qa_{t-1}[s] + self[s] + sub))
//       gdiag[s] += gA_t[s] * exp(qa_{t-1}[s-1] + next[s-1] + sub)
//     (exponents <= 0 by construction); gnext[s] = gdiag[s+1], 0 at s = S-1.
//   Then dT = (sum over b of acc_b) * E, summed in a fixed order by the
//   second kernel: no atomics, so every run gives the same bits.
// gI and gA rows t >= L stay as the wrapper allocated them (zeros); an
// element with L outside [1, T] has no path and contributes zeros
// everywhere, as K1 gives it -inf scores.
//
// What bounds it on an H100: the serial chain, as for K1.  Each element
// takes L dependent steps; the bytes (I, A, PB, QB read once, gI and gA
// written once) and the operations (about 4 N^2 a step: the alpha
// contraction and the rank-one transition update) are far below what the
// card moves and computes in that time.  The design keeps a step short:
//   - one block per element, walking only its own L steps;
//   - one thread per label and per target slot, FCC and FAC on the same
//     threads, and the six row reductions of a step packed into two block
//     barriers (one three-way max, one two-way sum), because the softmax
//     maxima and the rescale maximum need no result of each other;
//   - the previous alpha rows sit in double-buffered shared memory, so the
//     next step's writes never wait on this step's reads;
//   - thread i owns row i of the transition accumulator, so the rank-one
//     update needs no synchronisation: in shared memory when N*N fits
//     (after the rows and reduction slots), else in the (B, N, N) global
//     scratch, laid out so consecutive threads touch consecutive words;
//   - E^T sits in shared memory when it fits beside the accumulator, else
//     it is read from global memory, where it stays in L2;
//   - each next frame's four rows (I, A, PB, QB) are loaded into registers
//     one step ahead.

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 32;
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

// -inf-safe 2-way log-semiring sum: m + log(exp(a-m) + exp(b-m)).
template <typename T>
__device__ __forceinline__ T log_add(T a, T b) {
  T m = vmax(a, b);
  if (!is_finite(m)) return m;
  return m + d_log(d_exp(a - m) + d_exp(b - m));
}

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

// Shared memory: x[2][N] (FCC alpha rows), y[2][S+1] (qa + next shifted
// right by one slot, y[0] = -inf), the reduction slots (3 + 2) * kMaxWarps,
// then the accumulator acc[N*N] when it fits, then E^T[N*N] when it fits.
template <typename T>
__global__ void asg_bwd_kernel(
    const T* __restrict__ em,       // (T, B, N) emissions
    const T* __restrict__ al,       // (T, B, S) aligned emissions
    const T* __restrict__ et_glob,  // (N, N) E^T: et[j*N + i] = E[i][j]
    const T* __restrict__ self_t,   // (B, S)
    const T* __restrict__ next_t,   // (B, S)
    const int* __restrict__ li,
    const T* __restrict__ pb_in,    // (T, B, N) FCC beta residuals
    const T* __restrict__ qb_in,    // (T, B, S) FAC beta residuals
    const T* __restrict__ g_full,   // (B,)
    const T* __restrict__ g_fac,    // (B,)
    T* __restrict__ gi_out,         // (T, B, N)
    T* __restrict__ ga_out,         // (T, B, S)
    T* __restrict__ part,           // (B, N, N): part[b][j*N + i] = acc_b[i][j]
    T* __restrict__ gself, T* __restrict__ gnext,  // (B, S)
    int t_total, int batch, int n, int s, int acc_in_smem, int e_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xbuf = reinterpret_cast<T*>(smem_raw);
  T* ybuf = xbuf + 2 * n;
  T* red_max = ybuf + 2 * (s + 1);
  T* red_sum = red_max + 3 * kMaxWarps;
  T* extra = red_sum + 2 * kMaxWarps;

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int L = li[b];
  const bool lab = k < n;
  const bool slot = k < s;
  T* part_b = part + (size_t)b * n * n;
  T* acc = acc_in_smem ? extra : part_b;
  const T* e = et_glob;
  if (e_in_smem) {
    T* e_sm = extra + (acc_in_smem ? (size_t)n * n : 0);
    for (int idx = k; idx < n * n; idx += blockDim.x) e_sm[idx] = et_glob[idx];
    e = e_sm;
  }
  // thread k owns acc[j*N + k] for every j: no other thread touches it
  if (lab) {
    for (int j = 0; j < n; ++j) acc[(size_t)j * n + k] = T(0);
  }
  if (k == 0) {
    ybuf[0] = neg_inf<T>();
    ybuf[s + 1] = neg_inf<T>();
  }
  const T self_k = slot ? self_t[(size_t)b * s + k] : T(0);
  const T next_k = slot ? next_t[(size_t)b * s + k] : T(0);
  T acc_self = T(0), acc_diag = T(0);
  __syncthreads();  // E^T and the y sentinels are in place

  if (L >= 1 && L <= t_total) {
    const T gf = g_full[b];
    const T gq_scale = g_fac[b];
    T* x_prev = xbuf;
    T* x_cur = xbuf + n;
    T* y_prev = ybuf;
    T* y_cur = ybuf + (s + 1);
    T qa_prev = neg_inf<T>();

    size_t row = (size_t)b;  // frame 0
    T ev = lab ? em[row * n + k] : neg_inf<T>();
    T pbv = lab ? pb_in[row * n + k] : T(0);
    T av = slot ? al[row * s + k] : neg_inf<T>();
    T qbv = slot ? qb_in[row * s + k] : neg_inf<T>();

    for (int t = 0; t < L; ++t) {
      // prefetch frame t+1, consumed by the next step
      T ev_n = neg_inf<T>(), pb_n = T(0), av_n = neg_inf<T>(), qb_n = neg_inf<T>();
      const size_t row_n = (size_t)(t + 1) * batch + b;
      if (t + 1 < L) {
        if (lab) {
          ev_n = em[row_n * n + k];
          pb_n = pb_in[row_n * n + k];
        }
        if (slot) {
          av_n = al[row_n * s + k];
          qb_n = qb_in[row_n * s + k];
        }
      }

      // FCC alpha: s_k = sum_j E[k][j] pa_{t-1}[j]
      T sk = T(1);
      if (t > 0 && lab) {
        sk = T(0);
        for (int j = 0; j < n; ++j) sk += x_prev[j] * e[(size_t)j * n + k];
      }
      const T lpa = lab ? d_log(sk) + ev : neg_inf<T>();
      const T gam = lab ? lpa + d_log(pbv) : neg_inf<T>();

      // FAC alpha
      T qa = neg_inf<T>();
      T ysh = neg_inf<T>();
      if (slot) {
        if (t == 0) {
          qa = (k == 0) ? av : neg_inf<T>();
        } else {
          ysh = y_prev[k];
          qa = av + log_add(qa_prev + self_k, ysh);
        }
      }
      const T gamq = slot ? qa + qbv : neg_inf<T>();

      T mx[3] = {lpa, gam, gamq};
      block_reduce<T, 3, true>(mx, red_max);  // barrier 1
      const T m_a = is_finite(mx[0]) ? mx[0] : T(0);
      const T m_g = is_finite(mx[1]) ? mx[1] : T(0);
      const T m_q = is_finite(mx[2]) ? mx[2] : T(0);
      if (lab) x_cur[k] = d_exp(lpa - m_a);
      if (slot) y_cur[k + 1] = qa + next_k;
      const T eg = lab ? d_exp(gam - m_g) : T(0);
      const T eq = slot ? d_exp(gamq - m_q) : T(0);
      T sm[2] = {eg, eq};
      block_reduce<T, 2, false>(sm, red_sum);  // barrier 2
      const T gi = eg * (T(1) / (sm[0] > T(0) ? sm[0] : T(1))) * gf;
      const T gq = eq * (T(1) / (sm[1] > T(0) ? sm[1] : T(1))) * gq_scale;
      row = (size_t)t * batch + b;
      if (lab) gi_out[row * n + k] = gi;
      if (slot) ga_out[row * s + k] = gq;

      if (t > 0) {
        if (lab) {
          const T u = gi / (sk > T(0) ? sk : T(1));
          for (int j = 0; j < n; ++j) acc[(size_t)j * n + k] += u * x_prev[j];
        }
        if (slot) {
          const T sub = is_finite(qa) ? av - qa : neg_inf<T>();
          // slot 0 has only the self-loop in-edge, fraction 1
          const T hori = (k == 0) ? T(1) : d_exp(qa_prev + self_k + sub);
          acc_self += gq * hori;
          acc_diag += gq * d_exp(ysh + sub);
        }
      }

      qa_prev = qa;
      T* tx = x_prev; x_prev = x_cur; x_cur = tx;
      T* ty = y_prev; y_prev = y_cur; y_cur = ty;
      ev = ev_n;
      pbv = pb_n;
      av = av_n;
      qbv = qb_n;
    }
  }

  // gnext[s] = gdiag[s+1]: exchange through the y rows, idle by now
  __syncthreads();
  if (slot) ybuf[k] = acc_diag;
  __syncthreads();
  if (slot) {
    gself[(size_t)b * s + k] = acc_self;
    gnext[(size_t)b * s + k] = (k + 1 < s) ? ybuf[k + 1] : T(0);
  }
  if (acc_in_smem && lab) {
    for (int j = 0; j < n; ++j) part_b[(size_t)j * n + k] = acc[(size_t)j * n + k];
  }
}

// dT[i][j] = (sum over b, in order, of acc_b[i][j]) * E[i][j].
template <typename T>
__global__ void asg_dtrans_kernel(const T* __restrict__ part,
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

template <typename T>
int launch(const T* em, const T* al, const T* e, const T* e_t,
           const T* self_t, const T* next_t, const int* li, const T* pb_in,
           const T* qb_in, const T* g_full, const T* g_fac, T* gi_out,
           T* ga_out, T* part, T* d_trans, T* gself, T* gnext, int t_total,
           int batch, int n, int s, void* stream) {
  const int width = n > s ? n : s;
  const int threads = ((width + 31) / 32) * 32;
  if (threads > kMaxWarps * 32) return (int)cudaErrorInvalidValue;
  const size_t base =
      sizeof(T) * (2 * (size_t)n + 2 * ((size_t)s + 1) + 5 * kMaxWarps);
  const size_t square = sizeof(T) * (size_t)n * n;
  const int acc_in_smem = base + square <= kSmemLimit;
  const size_t with_acc = base + (acc_in_smem ? square : 0);
  const int e_in_smem = with_acc + square <= kSmemLimit;
  const size_t smem = with_acc + (e_in_smem ? square : 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        asg_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = (cudaStream_t)stream;
  asg_bwd_kernel<T><<<batch, threads, smem, st>>>(
      em, al, e_t, self_t, next_t, li, pb_in, qb_in, g_full, g_fac, gi_out,
      ga_out, part, gself, gnext, t_total, batch, n, s, acc_in_smem,
      e_in_smem);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cells = n * n;
  asg_dtrans_kernel<T><<<(cells + 255) / 256, 256, 0, st>>>(part, e, d_trans,
                                                           batch, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int asg_bwd_f32(const float* em, const float* al, const float* e,
                const float* e_t, const float* self_t, const float* next_t,
                const int* li, const float* pb_in, const float* qb_in,
                const float* g_full, const float* g_fac, float* gi_out,
                float* ga_out, float* part, float* d_trans, float* gself,
                float* gnext, int t_total, int batch, int n, int s,
                void* stream) {
  return launch<float>(em, al, e, e_t, self_t, next_t, li, pb_in, qb_in,
                       g_full, g_fac, gi_out, ga_out, part, d_trans, gself,
                       gnext, t_total, batch, n, s, stream);
}

int asg_bwd_f64(const double* em, const double* al, const double* e,
                const double* e_t, const double* self_t, const double* next_t,
                const int* li, const double* pb_in, const double* qb_in,
                const double* g_full, const double* g_fac, double* gi_out,
                double* ga_out, double* part, double* d_trans, double* gself,
                double* gnext, int t_total, int batch, int n, int s,
                void* stream) {
  return launch<double>(em, al, e, e_t, self_t, next_t, li, pb_in, qb_in,
                        g_full, g_fac, gi_out, ga_out, part, d_trans, gself,
                        gnext, t_total, batch, n, s, stream);
}

}  // extern "C"
