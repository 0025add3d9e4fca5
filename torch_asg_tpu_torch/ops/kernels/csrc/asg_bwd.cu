// Fused ASG gradients (kernel K2): both alpha chains of each batch element,
// recomputed with t ascending from the beta residuals that the store
// variant of K1 (asg_fwd.cu) wrote, and every gradient.  Two routes compute
// the same outputs: the warp route (three kernels, for max(N, S) <= 128)
// and the block route (one fused kernel and a sum, up to 1024).  The
// wrapper picks the route (common.py::width_route).
//
// Replaces: torch_asg_tpu/ops/pallas/asg_kernels.py::_bwd_kernel (launched
// by _run_bwd).  Its outputs are the contract; its TPU devices (time blocks
// of 8 steps, one (N, K*B) @ (K*B, N) MXU product per block, lane padding,
// wrap-rolls) do not carry over, but its split does: a serial part that
// only recomputes the chains' rows, and a part with no recurrence that
// computes the posteriors and the transition product from those rows.
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
//   Then dT = (sum of the acc partials) * E, summed in a fixed order: no
//   atomics, so every run gives the same bits.
// gI and gA rows t >= L stay as the wrapper allocated them (zeros); an
// element with L outside [1, T] has no path and contributes zeros
// everywhere, as K1 gives it -inf scores.
//
// What bounds both routes on an H100: the serial chains.  Each element
// takes L dependent steps; the bytes (I, A, PB, QB read once, gI and gA
// written once) and the operations (about 4 N^2 a frame: the alpha
// contraction and the rank-one transition update) are far below what the
// card moves and computes in that time.  So the time is (steps) x (latency
// of one step), and a design shortens the step.
//
// The warp route takes everything off the chains that the next step does
// not wait on.  A warp issues in order, so work placed in line with a chain
// adds its latency to the chain's (asg_fwd.cu, "Measured"); in the block
// route that work (the two posterior softmaxes, their block reductions, the
// stores, the rank-one update of the transition accumulator, the edge
// fractions) is most of a step.  Three kernels:
//   1. asg_bwd_warp_chain_kernel, the only one with a recurrence: one block
//      of two warps per element, warp 0 walking the FCC chain and warp 1
//      the FAC chain, no block barrier.  It is K1's warp route run forward
//      in time, with its devices: lanes hold labels or slots l, l+32, ...
//      (RN, RS = 1, 2 or 4 template parameters); the contraction reads a
//      double-buffered shared row as broadcasts into four partial sums,
//      with E zero-padded in shared memory; REDUX maxes in fp32; the
//      reciprocal's fast path; a register ring of kDepth = 4 frames with
//      the time loop unrolled by 4.  The FCC warp computes
//      pa_t = rescale(s_t * exp(I_t - max I_t)) to max 1 in the exp domain,
//      the emission max and exp row taken one frame ahead, off the chain,
//      and writes only the raw rows s_t to a scratch S (T, B, N).  The FAC
//      warp takes the neighbour s-1 from __shfl_up_sync (slot 32 r from
//      lane 31's register r-1), computes its lane's RS log-semiring sums
//      interleaved (log_add_row), and writes only the rows qa_t to a
//      scratch QA (T, B, S).
//   2. asg_bwd_warp_post_kernel: no recurrence, one block of four warps per
//      (element, chunk of frames), the chunks sized by the wrapper so that
//      the blocks fill the SMs.  Frame t needs rows t and t-1 of S, I, PB,
//      QA, A, QB.  A warp takes one frame at a time: both posterior
//      softmaxes (warp butterflies), the gI and gA rows, u_t = gI_t / s_t
//      and pa_{t-1} = exp(lpa_{t-1} - max) into a shared tile of 16
//      frames, and the edge fractions into per-lane gself and gdiag sums.
//      After each tile the block adds the tile's product
//      sum_t u_t (x) pa_{t-1} into its (N, N) partial in shared memory, one
//      thread per cell, frames in order: the TPU kernel's MXU product on
//      the CUDA cores.
//   3. asg_bwd_warp_sums_kernel: dT, 32 warps a block over fixed ranges of
//      the partials, combined in a fixed order; gself and gnext summed over
//      each element's chunks in order.
//
// The block route (asg_bwd_kernel, then asg_dtrans_kernel), for any width
// up to 1024, fuses all of it into one walk:
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

#include "chain_common.cuh"

namespace {

constexpr int kMaxWarps = 32;
constexpr size_t kSmemLimit = 227 * 1024;

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

// ------------------------------------------------------------ warp route

// Phase 1, the FCC warp of an element: lane l holds labels l, l+32, ... (RN
// words, N <= 32 RN).  Shared memory: E^T as K1's warp route holds E, WN x
// WN with WN = 32 RN (E[i][j] at j*WN + i, zero-padded, so lane i reads
// column i), then two rows of WN words.  Writes S[t, b, :] = s_t for
// t = 0 .. L-1.
template <typename T, int RN>
__device__ __forceinline__ void fcc_alpha_warp(
    const T* __restrict__ em, const T* __restrict__ et_glob, T* __restrict__ smem,
    T* __restrict__ s_out, int L, int b, int batch, int n, int lane) {
  constexpr int WN = 32 * RN;
  T* e = smem;
  T* xrows = smem + WN * WN;
  load_square<T, WN>(et_glob, e, n, lane);
  __syncwarp();  // E is in place

  // A ring of kDepth frames: frame f sits in slot f % kDepth and is loaded
  // kDepth steps before the step that consumes it (rows past frame L-1 are
  // clamped to it and never consumed).  The time loop is unrolled by
  // kDepth, so every slot index is a compile-time constant.
  T evb[kDepth][RN];
#pragma unroll
  for (int u = 0; u < kDepth; ++u) {
    const int f = u < L ? u : L - 1;
    load_row(em + ((size_t)f * batch + b) * n, n, lane, evb[u]);
  }
  // frame 0: s_0 = 1, pa_0 = rescale(exp(I_0 - max I_0)); then frame 1's
  // emission max and exp row
  T s[RN], x[RN], pa[RN], ex[RN];
  T m = warp_max_redux(lane_max(evb[0]));
  m = is_finite(m) ? m : T(0);
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    s[r] = T(1);
    x[r] = d_exp(evb[0][r] - m);
  }
  store_row(s_out + (size_t)b * n, n, lane, s);
  {
    const int f = kDepth < L ? kDepth : L - 1;
    load_row(em + ((size_t)f * batch + b) * n, n, lane, evb[0]);
  }
  T m_x = warp_max_redux(lane_max(x));
  T inv = rcp(m_x > T(0) ? m_x : T(1));
  m = warp_max_redux(lane_max(evb[1]));
  m = is_finite(m) ? m : T(0);
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    pa[r] = x[r] * inv;
    ex[r] = d_exp(evb[1][r] - m);
  }

  for (int t0 = 1; t0 < L; t0 += kDepth) {
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      // step t: frame t sits in slot cur (its exp row is ex), t+1 in slot nx
      const int t = t0 + u;
      if (t >= L) break;
      const int cur = (1 + u) % kDepth;
      const int nx = (2 + u) % kDepth;

      // pa_{t-1} through the shared row (double-buffered: one __syncwarp a
      // step); refill slot cur with frame t + kDepth
      T* xr = xrows + (u & 1) * WN;
#pragma unroll
      for (int r = 0; r < RN; ++r) xr[lane + 32 * r] = pa[r];
      const int f = t + kDepth < L ? t + kDepth : L - 1;
      load_row(em + ((size_t)f * batch + b) * n, n, lane, evb[cur]);
      __syncwarp();

      // s_t[i] = sum_j pa_{t-1}[j] E[i][j], stored raw; the rescale to max
      // 1; frame t+1's emission max and exp row for the next step
      contract_row<T, RN>(xr, e, lane, s);
      store_row(s_out + ((size_t)t * batch + b) * n, n, lane, s);
#pragma unroll
      for (int r = 0; r < RN; ++r) x[r] = s[r] * ex[r];
      m_x = warp_max_redux(lane_max(x));
      const T m_n = warp_max_redux(lane_max(evb[nx]));
      inv = rcp(m_x > T(0) ? m_x : T(1));
      m = is_finite(m_n) ? m_n : T(0);
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        pa[r] = x[r] * inv;
        ex[r] = d_exp(evb[nx][r] - m);
      }
    }
  }
}

// Phase 1, the FAC warp of an element: lane l holds slots l, l+32, ... (RS
// words, S <= 32 RS); the same ring of frames as the FCC warp's.  Writes
// QA[t, b, :] = qa_t for t = 0 .. L-1.
template <typename T, int RS>
__device__ __forceinline__ void fac_alpha_warp(
    const T* __restrict__ al, const T* __restrict__ self_t,
    const T* __restrict__ next_t, T* __restrict__ qa_out, int L, int b, int batch,
    int s, int lane) {
  T self_r[RS], next_r[RS], qa[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int k = lane + 32 * r;
    self_r[r] = k < s ? self_t[(size_t)b * s + k] : T(0);
    next_r[r] = k < s ? next_t[(size_t)b * s + k] : T(0);
  }
  T avb[kDepth][RS];
#pragma unroll
  for (int u = 0; u < kDepth; ++u) {
    const int f = u < L ? u : L - 1;
    load_row(al + ((size_t)f * batch + b) * s, s, lane, avb[u]);
  }
  // frame 0: slot 0 alone (slots past S hold -inf throughout)
#pragma unroll
  for (int r = 0; r < RS; ++r) qa[r] = lane + 32 * r == 0 ? avb[0][r] : neg_inf<T>();
  store_row(qa_out + (size_t)b * s, s, lane, qa);
  {
    const int f = kDepth < L ? kDepth : L - 1;
    load_row(al + ((size_t)f * batch + b) * s, s, lane, avb[0]);
  }

  for (int t0 = 1; t0 < L; t0 += kDepth) {
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int t = t0 + u;
      if (t >= L) break;
      const int cur = (1 + u) % kDepth;

      // y = qa + next; slot s takes y[s-1] from the lane below, slot 32 r
      // from lane 31's register r-1, slot 0 -inf
      T y[RS], hori[RS], diag[RS];
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        y[r] = qa[r] + next_r[r];
        hori[r] = qa[r] + self_r[r];
      }
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        const T up = __shfl_up_sync(kFull, y[r], 1);
        const T wrap = r > 0 ? __shfl_sync(kFull, y[r > 0 ? r - 1 : 0], 31) : neg_inf<T>();
        diag[r] = lane == 0 ? wrap : up;
      }
      log_add_row(hori, diag, y);
#pragma unroll
      for (int r = 0; r < RS; ++r) qa[r] = avb[cur][r] + y[r];
      const int f = t + kDepth < L ? t + kDepth : L - 1;
      load_row(al + ((size_t)f * batch + b) * s, s, lane, avb[cur]);
      store_row(qa_out + ((size_t)t * batch + b) * s, s, lane, qa);
    }
  }
}

// Phase 1: one block of two warps per element, warp 0 the FCC chain, warp 1
// the FAC chain.  The chains never exchange data: no block barrier at all.
template <typename T, int RN, int RS>
__global__ void __launch_bounds__(64, 1) asg_bwd_warp_chain_kernel(
    const T* __restrict__ em,       // (T, B, N) emissions
    const T* __restrict__ al,       // (T, B, S) aligned emissions
    const T* __restrict__ et_glob,  // (N, N) E^T: et[j*N + i] = E[i][j]
    const T* __restrict__ self_t,   // (B, S)
    const T* __restrict__ next_t,   // (B, S)
    const int* __restrict__ li,
    T* __restrict__ s_out,          // (T, B, N) the raw FCC rows s_t
    T* __restrict__ qa_out,         // (T, B, S) the FAC rows qa_t
    int t_total, int batch, int n, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int L = li[b];
  if (L < 1 || L > t_total) return;  // no path: no row is read
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    fcc_alpha_warp<T, RN>(em, et_glob, reinterpret_cast<T*>(smem_raw), s_out, L, b,
                          batch, n, lane);
  } else {
    fac_alpha_warp<T, RS>(al, self_t, next_t, qa_out, L, b, batch, s, lane);
  }
}

constexpr int kPostWarps = 4;
constexpr int kPostFrames = 4;  // frames a warp takes per tile
constexpr int kTile = kPostWarps * kPostFrames;

// Phase 2, the FCC side of frame t for one warp: the gI row, and the
// tile's rows u_t = gI_t / s_t and pa_{t-1} (both 0 at t = 0), WN words
// each, zero past N.
template <typename T, int RN>
__device__ __forceinline__ void fcc_posterior(
    const T* __restrict__ em, const T* __restrict__ s_in, const T* __restrict__ pb_in,
    T* __restrict__ gi_out, T* __restrict__ urow, T* __restrict__ prow, int t, int b,
    int batch, int n, int lane, T gf) {
  const size_t row = ((size_t)t * batch + b) * n;
  T sv[RN], gam[RN];
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int k = lane + 32 * r;
    sv[r] = k < n ? s_in[row + k] : T(1);
    gam[r] = k < n ? d_log(sv[r]) + em[row + k] + d_log(pb_in[row + k]) : neg_inf<T>();
  }
  T m = warp_max(lane_max(gam));
  m = is_finite(m) ? m : T(0);
  T eg[RN], tot = T(0);
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    eg[r] = d_exp(gam[r] - m);
    tot += eg[r];
  }
  tot = warp_sum(tot);
  const T inv = rcp(tot > T(0) ? tot : T(1));
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int k = lane + 32 * r;
    const T gi = eg[r] * inv * gf;
    if (k < n) gi_out[row + k] = gi;
    urow[k] = t > 0 ? gi * rcp(sv[r] > T(0) ? sv[r] : T(1)) : T(0);
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < RN; ++r) prow[lane + 32 * r] = T(0);
    return;
  }
  // pa_{t-1} = exp(lpa_{t-1} - max), lpa_{t-1} = log s_{t-1} + I_{t-1}
  const size_t prev = row - (size_t)batch * n;
  T lp[RN];
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int k = lane + 32 * r;
    lp[r] = k < n ? d_log(s_in[prev + k]) + em[prev + k] : neg_inf<T>();
  }
  T ma = warp_max(lane_max(lp));
  ma = is_finite(ma) ? ma : T(0);
#pragma unroll
  for (int r = 0; r < RN; ++r) prow[lane + 32 * r] = d_exp(lp[r] - ma);
}

// Phase 2, the FAC side of frame t for one warp: the gA row, and for
// t >= 1 the edge fractions weighted into the lanes' gself and gdiag sums.
// The element's self and next rows are read from shared memory where they
// are used, not held in registers across the frames: held, ptxas spills
// them.
template <typename T, int RS>
__device__ __forceinline__ void fac_posterior(
    const T* __restrict__ al, const T* __restrict__ qa_in, const T* __restrict__ qb_in,
    T* __restrict__ ga_out, const T* self_sm, const T* next_sm,
    T (&a_self)[RS], T (&a_diag)[RS], int t, int b, int batch, int s, int lane,
    T gq_scale) {
  const size_t row = ((size_t)t * batch + b) * s;
  T qa[RS], gam[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int k = lane + 32 * r;
    qa[r] = k < s ? qa_in[row + k] : neg_inf<T>();
    gam[r] = k < s ? qa[r] + qb_in[row + k] : neg_inf<T>();
  }
  T m = warp_max(lane_max(gam));
  m = is_finite(m) ? m : T(0);
  T eq[RS], tot = T(0);
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    eq[r] = d_exp(gam[r] - m);
    tot += eq[r];
  }
  tot = warp_sum(tot);
  const T inv = rcp(tot > T(0) ? tot : T(1));
  T gq[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    gq[r] = eq[r] * inv * gq_scale;
    if (lane + 32 * r < s) ga_out[row + lane + 32 * r] = gq[r];
  }
  if (t == 0) return;  // t = 0 carries no edge mass
  const size_t prev = row - (size_t)batch * s;
  T qp[RS], y[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int k = lane + 32 * r;
    qp[r] = k < s ? qa_in[prev + k] : neg_inf<T>();
    y[r] = qp[r] + next_sm[k];
  }
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int k = lane + 32 * r;
    const T up = __shfl_up_sync(kFull, y[r], 1);
    const T wrap = r > 0 ? __shfl_sync(kFull, y[r > 0 ? r - 1 : 0], 31) : neg_inf<T>();
    const T av = k < s ? al[row + k] : neg_inf<T>();
    const T sub = is_finite(qa[r]) ? av - qa[r] : neg_inf<T>();
    // slot 0 has only the self-loop in-edge, fraction 1
    const T hori = k == 0 ? T(1) : d_exp(qp[r] + self_sm[k] + sub);
    a_self[r] += gq[r] * hori;
    a_diag[r] += gq[r] * d_exp((lane == 0 ? wrap : up) + sub);
  }
}

// Phase 2: one block per (element b = blockIdx.y, chunk c = blockIdx.x of
// ``chunk`` frames).  Writes the gI and gA rows of the chunk's frames
// t < L, the chunk's (N, N) transition partial part[p] (part[p][i*N + j],
// p = b * chunks + c) and its FAC partials pself[p], pdiag[p]; a chunk past
// L, or of an element with no path, writes zero partials.  Shared memory:
// the (WN, WN) accumulator, then the tile's u and pa rows, (kTile, WN)
// each (after the tiles the FAC warps' sums reuse them), then the
// element's self and next rows, WS words each, zero past S.
template <typename T, int RN, int RS>
__global__ void __launch_bounds__(kPostWarps * 32) asg_bwd_warp_post_kernel(
    const T* __restrict__ em, const T* __restrict__ al, const T* __restrict__ self_t,
    const T* __restrict__ next_t, const int* __restrict__ li,
    const T* __restrict__ pb_in, const T* __restrict__ qb_in,
    const T* __restrict__ g_full, const T* __restrict__ g_fac,
    const T* __restrict__ s_in, const T* __restrict__ qa_in,
    T* __restrict__ gi_out, T* __restrict__ ga_out, T* __restrict__ part,
    T* __restrict__ pself, T* __restrict__ pdiag, int t_total, int batch, int n,
    int s, int chunk) {
  constexpr int WN = 32 * RN, WS = 32 * RS;
  constexpr int kThreads = kPostWarps * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // acc[i*WN + j]
  T* urow = acc + WN * WN;
  T* prow = urow + kTile * WN;
  T* red = urow;  // (2, kPostWarps, WS) once the tiles are done
  T* self_sm = prow + kTile * WN;
  T* next_sm = self_sm + WS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const size_t p = (size_t)b * gridDim.x + blockIdx.x;
  const int L = li[b];
  const int t_begin = blockIdx.x * chunk;
  int t_end = L < t_begin + chunk ? L : t_begin + chunk;
  if (L < 1 || L > t_total) t_end = t_begin;

  // thread tid owns the cells tid, tid + kThreads, ... of acc throughout
  for (int idx = tid; idx < WN * WN; idx += kThreads) acc[idx] = T(0);
  for (int k = tid; k < WS; k += kThreads) {
    self_sm[k] = k < s ? self_t[(size_t)b * s + k] : T(0);
    next_sm[k] = k < s ? next_t[(size_t)b * s + k] : T(0);
  }
  T a_self[RS], a_diag[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    a_self[r] = T(0);
    a_diag[r] = T(0);
  }
  const T gf = g_full[b], gq_scale = g_fac[b];
  __syncthreads();  // self and next are in place

  for (int t_tile = t_begin; t_tile < t_end; t_tile += kTile) {
    for (int q = 0; q < kPostFrames; ++q) {
      const int f = warp * kPostFrames + q;
      const int t = t_tile + f;
      if (t >= t_end) break;
      fcc_posterior<T, RN>(em, s_in, pb_in, gi_out, urow + f * WN, prow + f * WN, t, b,
                           batch, n, lane, gf);
      fac_posterior<T, RS>(al, qa_in, qb_in, ga_out, self_sm, next_sm, a_self, a_diag, t,
                           b, batch, s, lane, gq_scale);
    }
    __syncthreads();  // the tile's rows are in place
    // acc[i][j] += the tile's frames, in order, of u_t[i] pa_{t-1}[j]
    const int nf = t_end - t_tile < kTile ? t_end - t_tile : kTile;
    for (int idx = tid; idx < WN * WN; idx += kThreads) {
      const int i = idx / WN, j = idx - i * WN;
      T a = acc[idx];
      for (int f = 0; f < nf; ++f) a += urow[f * WN + i] * prow[f * WN + j];
      acc[idx] = a;
    }
    __syncthreads();  // the next tile may overwrite the rows
  }

  T* part_p = part + p * n * n;
  for (int idx = tid; idx < WN * WN; idx += kThreads) {
    const int i = idx / WN, j = idx - i * WN;
    if (i < n && j < n) part_p[(size_t)i * n + j] = acc[idx];
  }
  // the FAC partials: the warps' sums combined in a fixed order
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    red[warp * WS + lane + 32 * r] = a_self[r];
    red[(kPostWarps + warp) * WS + lane + 32 * r] = a_diag[r];
  }
  __syncthreads();
  for (int k = tid; k < s; k += kThreads) {
    T gs = red[k], gd = red[kPostWarps * WS + k];
    for (int w = 1; w < kPostWarps; ++w) {
      gs += red[w * WS + k];
      gd += red[(kPostWarps + w) * WS + k];
    }
    pself[p * s + k] = gs;
    pdiag[p * s + k] = gd;
  }
}

constexpr int kSumWarps = 32;

// Phase 3.  Blocks [0, cell_blocks): dT for 32 cells a block (cell = i*N +
// j), warp w summing a fixed range of the partials in order, the warps'
// sums then combined in order: dT[i][j] = sum * E[i][j].  The blocks past
// them: one thread per (element, slot), gself = the sum of the chunks'
// pself in order, gnext[s] = that of pdiag[s+1], 0 at s = S-1.
template <typename T>
__global__ void __launch_bounds__(kSumWarps * 32) asg_bwd_warp_sums_kernel(
    const T* __restrict__ part, const T* __restrict__ e_glob,  // E[i*N + j]
    const T* __restrict__ pself, const T* __restrict__ pdiag,
    T* __restrict__ d_trans, T* __restrict__ gself, T* __restrict__ gnext, int nparts,
    int nchunks, int batch, int n, int s, int cell_blocks) {
  __shared__ T red[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if ((int)blockIdx.x < cell_blocks) {
    const int cells = n * n;
    const int cell = blockIdx.x * 32 + lane;
    const int per = (nparts + kSumWarps - 1) / kSumWarps;
    const int p0 = warp * per;
    const int count = (p0 + per < nparts ? p0 + per : nparts) - p0;
    T sum = T(0);
    if (cell < cells) {
      const T* src = part + (size_t)p0 * cells + cell;
      for (int q = 0; q < count; ++q, src += cells) sum += *src;
    }
    red[warp][lane] = sum;
    __syncthreads();
    if (warp == 0 && cell < cells) {
      T tot = red[0][lane];
      for (int w = 1; w < kSumWarps; ++w) tot += red[w][lane];
      d_trans[cell] = tot * e_glob[cell];
    }
    return;
  }
  const int idx = (blockIdx.x - cell_blocks) * blockDim.x + threadIdx.x;
  if (idx >= batch * s) return;
  const int b = idx / s, k = idx - b * s;
  const size_t first = (size_t)b * nchunks * s + k;
  const T* ps = pself + first;
  const T* pd = pdiag + first + 1;
  const bool has_next = k + 1 < s;
  T gs = T(0), gd = T(0);
  for (int c = 0; c < nchunks; ++c, ps += s, pd += s) {
    gs += *ps;
    if (has_next) gd += *pd;
  }
  gself[idx] = gs;
  gnext[idx] = gd;
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The warp route's arguments: the block route's, with the chain rows S and
// QA, the (chunks * B, N, N) transition partials and the (2, chunks * B, S)
// FAC partials as scratch.
template <typename T>
struct WarpArgs {
  const T *em, *al, *e, *e_t, *self_t, *next_t;
  const int* li;
  const T *pb_in, *qb_in, *g_full, *g_fac;
  T *gi_out, *ga_out, *d_trans, *gself, *gnext, *s_buf, *qa_buf, *part, *pedge;
  int t_total, batch, n, s, chunk;
  cudaStream_t stream;
};

template <typename T, int RN, int RS>
int launch_warp_r(const WarpArgs<T>& a) {
  constexpr int WN = 32 * RN;
  const size_t smem1 = sizeof(T) * (size_t)(WN * WN + 2 * WN);
  cudaError_t err = set_smem((const void*)asg_bwd_warp_chain_kernel<T, RN, RS>, smem1);
  if (err != cudaSuccess) return (int)err;
  asg_bwd_warp_chain_kernel<T, RN, RS><<<a.batch, 64, smem1, a.stream>>>(
      a.em, a.al, a.e_t, a.self_t, a.next_t, a.li, a.s_buf, a.qa_buf, a.t_total,
      a.batch, a.n, a.s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int nchunks = (a.t_total + a.chunk - 1) / a.chunk;
  const int nparts = a.batch * nchunks;
  T* pself = a.pedge;
  T* pdiag = a.pedge + (size_t)nparts * a.s;
  const size_t smem2 = sizeof(T) * (size_t)(WN * WN + 2 * kTile * WN + 2 * 32 * RS);
  err = set_smem((const void*)asg_bwd_warp_post_kernel<T, RN, RS>, smem2);
  if (err != cudaSuccess) return (int)err;
  asg_bwd_warp_post_kernel<T, RN, RS>
      <<<dim3(nchunks, a.batch), kPostWarps * 32, smem2, a.stream>>>(
          a.em, a.al, a.self_t, a.next_t, a.li, a.pb_in, a.qb_in, a.g_full, a.g_fac,
          a.s_buf, a.qa_buf, a.gi_out, a.ga_out, a.part, pself, pdiag, a.t_total,
          a.batch, a.n, a.s, a.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int cell_blocks = (a.n * a.n + 31) / 32;
  const int fac_blocks = (a.batch * a.s + kSumWarps * 32 - 1) / (kSumWarps * 32);
  asg_bwd_warp_sums_kernel<T><<<cell_blocks + fac_blocks, kSumWarps * 32, 0, a.stream>>>(
      a.part, a.e, pself, pdiag, a.d_trans, a.gself, a.gnext, nparts, nchunks, a.batch,
      a.n, a.s, cell_blocks);
  return (int)cudaGetLastError();
}

// RS = 1, 2 or 4 words a lane of each slot row: S <= 128.
template <typename T, int RN>
int launch_warp_rn(const WarpArgs<T>& a) {
  if (a.s <= 32) return launch_warp_r<T, RN, 1>(a);
  if (a.s <= 64) return launch_warp_r<T, RN, 2>(a);
  if (a.s <= 128) return launch_warp_r<T, RN, 4>(a);
  return (int)cudaErrorInvalidValue;
}

// RN = 1, 2 or 4 words a lane of each label row: N <= 128.
template <typename T>
int launch_warp(const WarpArgs<T>& a) {
  if (a.chunk < 1) return (int)cudaErrorInvalidValue;
  if (a.n <= 32) return launch_warp_rn<T, 1>(a);
  if (a.n <= 64) return launch_warp_rn<T, 2>(a);
  if (a.n <= 128) return launch_warp_rn<T, 4>(a);
  return (int)cudaErrorInvalidValue;
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

// The warp route: the block route's inputs and outputs, then its scratch
// (S, QA, the transition partials, the FAC partials), then the sizes and
// the frames per chunk of the posterior phase.

int asg_bwd_warp_f32(const float* em, const float* al, const float* e,
                     const float* e_t, const float* self_t, const float* next_t,
                     const int* li, const float* pb_in, const float* qb_in,
                     const float* g_full, const float* g_fac, float* gi_out,
                     float* ga_out, float* d_trans, float* gself, float* gnext,
                     float* s_buf, float* qa_buf, float* part, float* pedge,
                     int t_total, int batch, int n, int s, int chunk, void* stream) {
  return launch_warp<float>({em, al, e, e_t, self_t, next_t, li, pb_in, qb_in, g_full,
                             g_fac, gi_out, ga_out, d_trans, gself, gnext, s_buf, qa_buf,
                             part, pedge, t_total, batch, n, s, chunk,
                             (cudaStream_t)stream});
}

int asg_bwd_warp_f64(const double* em, const double* al, const double* e,
                     const double* e_t, const double* self_t, const double* next_t,
                     const int* li, const double* pb_in, const double* qb_in,
                     const double* g_full, const double* g_fac, double* gi_out,
                     double* ga_out, double* d_trans, double* gself, double* gnext,
                     double* s_buf, double* qa_buf, double* part, double* pedge,
                     int t_total, int batch, int n, int s, int chunk, void* stream) {
  return launch_warp<double>({em, al, e, e_t, self_t, next_t, li, pb_in, qb_in, g_full,
                              g_fac, gi_out, ga_out, d_trans, gself, gnext, s_buf,
                              qa_buf, part, pedge, t_total, batch, n, s, chunk,
                              (cudaStream_t)stream});
}

}  // extern "C"
