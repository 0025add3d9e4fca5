// The fully-connected (FCC) lattice's per-lattice kernels, log domain:
//   K3  fcc_fwd   the alpha chain (t ascending) and the beta chain
//                 (t descending);
//   K4  fcc_beta  the beta chain alone (the score-only primal);
//   K5  fcc_bwd   the emission posteriors and the transition partials,
//                 then a second kernel sums the partials in a fixed order.
// K3, K4 and K5 each have two routes with the same outputs: the warp route
// (N <= 128) and the block route (N <= 512).  The wrapper picks the route
// (common.py::width_route).
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
//   K5, for t = 0 .. min(L, T) - 1 of an element with L in [1, T]:
//     dI_t = softmax(alpha_t + beta_t) * g[b]   (zeros on an all--inf row)
//     acc[i][j] += u_t[i] v_t[j],   v_t = exp(alpha_{t-1} - m_{t-1})
//       u_t = dI_t * exp(where(alpha_t finite, I_t - alpha_t, -inf)
//                        + m_{t-1} + c)                        (t >= 1)
//   and dT = (sum of the partials acc) * E.  Every other dI row is 0.
//
// What bounds them on an H100.  K3 and K4 are serial chains: each element
// takes about L dependent steps, and the bytes (each row read and written
// once) and the operations (an N-term dot per label and chain a step) are
// far below what the card moves and computes in that time, so the time is
// (steps) x (latency of one step), and a design shortens the step.  K5 has
// no recurrence: frame t needs only alpha_t, beta_t, I_t and alpha_{t-1}.
// Its bound is its bytes; a design that walks the frames in order pays a
// chain's latency for work with none.
//
// The warp routes (N <= 128; lanes hold labels l, l+32, ..., RN = 1, 2 or
// 4 words of a row, a template parameter):
//   - K3, fcc_fwd_warp_kernel: one block of two warps per element, warp 0
//     walking the alpha chain and warp 1 the beta chain, with no block
//     barrier in the time loop.  Both chains run in the exp domain with a
//     per-step rescale to max 1, as K1's and K2's FCC chains do: a step is
//     the contraction, a product with the emission exp row, a REDUX max
//     and a reciprocal; the log-scale offset of each row is kept beside
//     the chain, off it.  One copy of E sits in shared memory, zero-padded
//     to WN x (WN + 1): beta reads column i (consecutive lanes,
//     consecutive words), alpha row i (an odd stride, so no two lanes
//     share a bank).  The row each step contracts goes through a
//     double-buffered shared row read as broadcasts into four partial
//     sums; the emission rows wait in a register ring kDepth = 4 frames
//     deep, with the time loop unrolled by 4 (chain_common.cuh).  The
//     chains write raw rows (s_t, y_t) and a per-frame offset; the log of
//     each row, which no later step waits on, is taken by
//     fcc_fwd_log_kernel, a frame-parallel pass launched next.  Logs taken
//     on the chains' warps lengthened the chains by more than the pass
//     costs (PERF.md section 6).
//   - K4, fcc_beta_warp_kernel: K3's beta warp alone, one block of one warp
//     per element (E in shared memory as above, one __syncwarp before the
//     walk), writing the raw rows y_t and the per-frame offsets; then
//     fcc_beta_log_kernel, the same frame-parallel pass for beta alone,
//     which also writes the -inf rows.  Its pace is K3's beta chain's.
//   - K5, fcc_bwd_post_kernel: one block of four warps per (element, chunk
//     of frames), sized by the wrapper so that the blocks fill the SMs.  A
//     warp takes one frame at a time: the posterior softmax (warp
//     shuffles), the dI row, and the rows u_t and v_t into a shared tile of
//     16 frames; after each tile the block adds the tile's product
//     sum_t u_t (x) v_t into its (N, N) partial in shared memory, one
//     thread per cell, frames in order.  fcc_bwd_sums_kernel then sums the
//     (element, chunk) partials in a fixed order: no atomics, so two runs
//     give the same bits.
//
// Both routes' times on an H100, and each warp-route kernel's device
// time, are in PERF.md section 6 (chip_smoke.py).
//
// The block routes (any width up to 512), one block per element walking
// its own steps, one thread per label:
//   - K3 runs both chains on the same threads, log domain, so one step
//     costs two block barriers for both chains: the two row maxima in one
//     reduction, then the exchange of the two exp rows; K4 is the same
//     template with the alpha chain compiled out, and pays the same two
//     barriers a step for beta alone;
//   - E sits in shared memory when it fits (fp32 N <= 238, fp64 N <= 168),
//     one copy with an odd row stride, read as the warp route reads it;
//     past that both chains read global memory, where E stays in L2, beta
//     from E and alpha from E^T, so both reads are coalesced;
//   - the next step's emission rows are loaded into registers one step
//     ahead;
//   - K5 walks t in order with two block reductions a frame; thread i owns
//     row i of the transition accumulator (shared memory when N*N fits,
//     else the (B, N, N) scratch), so the rank-one update needs no
//     synchronisation and no atomics; fcc_dtrans_kernel sums the partials
//     over b in order.

#include "chain_common.cuh"

namespace {

constexpr int kMaxWarps = 16;  // 512 threads: the tier's width cap
constexpr size_t kSmemLimit = 227 * 1024;

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

// ------------------------------------------------------------ warp routes

// E = exp(T - c) for both chains of K3's warp route, one copy in shared
// memory: WN x LD with LD = WN + 1 (odd), e_sm[j*LD + i] = E[j][i], zero
// for i >= N or j >= N (so a contraction runs over all WN terms without a
// branch), loaded by every thread of the block.
template <typename T, int WN>
__device__ __forceinline__ void load_e_padded(const T* __restrict__ e_glob,
                                              T* __restrict__ e_sm, int n) {
  constexpr int LD = WN + 1;
  for (int idx = threadIdx.x; idx < WN * LD; idx += blockDim.x) {
    const int j = idx / LD, i = idx - j * LD;
    e_sm[idx] = (j < n && i < n) ? e_glob[(size_t)j * n + i] : T(0);
  }
}

// sum_i = sum_j x_j M[j][i] for lane l's labels i = l + 32 r: M = E
// (kTrans false, E[j][i] at j*LD + i: lane i reads column i) or E^T (kTrans,
// E[i][j] at i*LD + j: lane i reads row i at the odd stride LD).  The row x
// (WN words, 16-byte aligned, in shared memory) is read as broadcasts, four
// values per load, into four partial sums (j mod 4).  Fully unrolled where
// a lane's row is at most 8 bytes, as chain_common.cuh's contract_row.
template <typename T, int RN, bool kTrans>
__device__ __forceinline__ void contract_padded(const T* __restrict__ x,
                                                const T* __restrict__ e, int lane,
                                                T (&sum)[RN]) {
  constexpr int WN = 32 * RN, LD = WN + 1;
  constexpr int kGroups = RN * sizeof(T) <= 8 ? WN / 4 : 4;
  T acc[4][RN];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int r = 0; r < RN; ++r) acc[q][r] = T(0);
  }
#pragma unroll kGroups
  for (int j = 0; j < WN; j += 4) {
    T xv[4];
    load4(x + j, xv);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const int i = lane + 32 * r;
        acc[q][r] += xv[q] * (kTrans ? e[i * LD + j + q] : e[(j + q) * LD + i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RN; ++r) sum[r] = (acc[0][r] + acc[1][r]) + (acc[2][r] + acc[3][r]);
}

// K3's alpha warp, t = 0 .. L-1 (L = min(L_in, T) >= 1).  Exp domain:
// s_t = pa_{t-1} E^T (s_0 = 1), pa_t = rescale(s_t * exp(I_t - max I_t)) to
// max 1, and A_t, the log-scale offset of pa_t (alpha_t = log pa_t + A_t),
// kept beside the chain.  So alpha_t = I_t + log s_t + o_t with
// o_t = A_{t-1} + c (o_0 = 0).  It writes the raw row s_t into ``out``
// and o_t into off_out[t, b], which fcc_fwd_log_kernel turns into alpha_t.
// The emission rows wait in a ring of kDepth frames (frame f in slot
// f % kDepth, loaded kDepth steps before its step; rows past frame L-1 are
// clamped to it and never consumed), and the max and exp row of frame t+1
// are taken during step t, off the chain.
template <typename T, int RN>
__device__ __forceinline__ void k3_alpha_warp(
    const T* __restrict__ em, const T* __restrict__ e, T* __restrict__ xrows,
    T* __restrict__ out, T* __restrict__ off_out, T c, int L, int b, int batch, int n,
    int lane) {
  constexpr int WN = 32 * RN;
  T evb[kDepth][RN];
#pragma unroll
  for (int u = 0; u < kDepth; ++u) {
    const int f = u < L ? u : L - 1;
    load_row(em + ((size_t)f * batch + b) * n, n, lane, evb[u]);
  }
  // frame 0: alpha_0 = I_0 (s_0 = 1, o_0 = 0), pa_0 and A_0; then frame 1's
  // emission max and exp row
  T s[RN], x[RN], pa[RN], ex[RN];
  T m = warp_max_redux(lane_max(evb[0]));
  m = is_finite(m) ? m : T(0);
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    s[r] = T(1);
    x[r] = d_exp(evb[0][r] - m);
  }
  store_row(out + (size_t)b * n, n, lane, s);
  if (lane == 0) off_out[b] = T(0);
  {
    const int f = kDepth < L ? kDepth : L - 1;
    load_row(em + ((size_t)f * batch + b) * n, n, lane, evb[0]);
  }
  T m_x = warp_max_redux(lane_max(x));
  T m_s = m_x > T(0) ? m_x : T(1);
  T inv = rcp(m_s);
  T a_off = m + d_log(m_s);
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
      // step t: frame t sits in slot cur (its max m and exp row ex), frame
      // t+1 in slot nx
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

      // s_t[i] = sum_j pa_{t-1}[j] E[i][j]
      contract_padded<T, RN, true>(xr, e, lane, s);
      const T o = a_off + c;
      const size_t row = (size_t)t * batch + b;
      store_row(out + row * n, n, lane, s);
      if (lane == 0) off_out[row] = o;
      // the rescale to max 1; frame t+1's emission max and exp row
#pragma unroll
      for (int r = 0; r < RN; ++r) x[r] = s[r] * ex[r];
      m_x = warp_max_redux(lane_max(x));
      const T m_n = warp_max_redux(lane_max(evb[nx]));
      m_s = m_x > T(0) ? m_x : T(1);
      inv = rcp(m_s);
      a_off = o + m + d_log(m_s);
      m = is_finite(m_n) ? m_n : T(0);
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        pa[r] = x[r] * inv;
        ex[r] = d_exp(evb[nx][r] - m);
      }
    }
  }
}

// K3's beta warp, t = L-1 .. 0 (L = L_in in [1, T]), K1's FCC warp with
// the log-scale offset kept: pb_t = rescale(y_t) to max 1, y_t =
// (pb_{t+1} * exp(I_{t+1} - max I_{t+1})) E, pb_{L-1} = 1.  So beta_t =
// log y_t + o_t with o_t the offset of pb_{t+1} plus max I_{t+1} plus c
// (o_{L-1} = 0, y_{L-1} = 1).  It writes y_t and o_t, as the alpha warp
// does.  Frame f sits in ring slot (L-1-f) % kDepth.
template <typename T, int RN>
__device__ __forceinline__ void k3_beta_warp(
    const T* __restrict__ em, const T* __restrict__ e, T* __restrict__ xrows,
    T* __restrict__ out, T* __restrict__ off_out, T c, int L, int b, int batch, int n,
    int lane) {
  constexpr int WN = 32 * RN;
  T pb[RN];
#pragma unroll
  for (int r = 0; r < RN; ++r) pb[r] = T(1);
  {
    const size_t row = (size_t)(L - 1) * batch + b;
    store_row(out + row * n, n, lane, pb);
    if (lane == 0) off_out[row] = T(0);
  }
  T evb[kDepth][RN];
#pragma unroll
  for (int u = 0; u < kDepth; ++u) {
    const int f = L - 1 - u >= 0 ? L - 1 - u : 0;
    load_row(em + ((size_t)f * batch + b) * n, n, lane, evb[u]);
  }
  // the max and exp row of the frame the next step consumes
  T m = warp_max_redux(lane_max(evb[0]));
  m = is_finite(m) ? m : T(0);
  T ex[RN];
#pragma unroll
  for (int r = 0; r < RN; ++r) ex[r] = d_exp(evb[0][r] - m);

  T b_off = T(0);
  for (int t0 = L - 2; t0 >= 0; t0 -= kDepth) {
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      // step t consumes frame t+1 (slot u); slot (u+1) % kDepth holds frame t
      const int t = t0 - u;
      if (t < 0) break;
      const int nx = (u + 1) % kDepth;

      T* xr = xrows + (u & 1) * WN;
#pragma unroll
      for (int r = 0; r < RN; ++r) xr[lane + 32 * r] = pb[r] * ex[r];
      const int f = t + 1 - kDepth;
      load_row(em + ((size_t)(f >= 0 ? f : 0) * batch + b) * n, n, lane, evb[u]);
      __syncwarp();

      // y_t[i] = sum_j x_j E[j][i]
      T y[RN];
      contract_padded<T, RN, false>(xr, e, lane, y);
      const T o = (b_off + m) + c;
      const size_t row = (size_t)t * batch + b;
      store_row(out + row * n, n, lane, y);
      if (lane == 0) off_out[row] = o;
      // the rescale to max 1; frame t's emission max and exp row
      const T m_a = warp_max_redux(lane_max(y));
      const T m_n = warp_max_redux(lane_max(evb[nx]));
      const T m_s = m_a > T(0) ? m_a : T(1);
      const T inv = rcp(m_s);
#pragma unroll
      for (int r = 0; r < RN; ++r) pb[r] = y[r] * inv;
      b_off = o + d_log(m_s);
      m = is_finite(m_n) ? m_n : T(0);
#pragma unroll
      for (int r = 0; r < RN; ++r) ex[r] = d_exp(evb[nx][r] - m);
    }
  }
}

// K3's warp route: one block of two warps per element, warp 0 the alpha
// chain and warp 1 the beta chain.  One block barrier, before the time
// loops (E in place); none in them.  Shared memory: two double-buffered
// rows of WN words for each warp, then E (load_e_padded).  The -inf rows
// (t >= min(L, T) for alpha, t >= L for beta, every row of beta when L is
// outside [1, T]) are fcc_fwd_log_kernel's.
template <typename T, int RN>
__global__ void __launch_bounds__(64, 1) fcc_fwd_warp_kernel(
    const T* __restrict__ em,       // (T, B, N) emissions
    const T* __restrict__ e_glob,   // (N, N) e[j*N + i] = exp(T[j][i] - c)
    const T* __restrict__ c_ptr,    // () the max finite transition
    const int* __restrict__ li,
    T* __restrict__ alpha_out,      // (T, B, N)
    T* __restrict__ beta_out,       // (T, B, N)
    T* __restrict__ off_a,          // (T, B) alpha's per-frame offsets
    T* __restrict__ off_b,          // (T, B) beta's
    int t_total, int batch, int n) {
  constexpr int WN = 32 * RN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xrows = reinterpret_cast<T*>(smem_raw);
  T* e = xrows + 4 * WN;
  const int b = blockIdx.x;
  const int L = li[b];
  const int la = L < 0 ? 0 : (L > t_total ? t_total : L);  // alpha's live rows
  const int lb = (L >= 1 && L <= t_total) ? L : 0;          // beta's live rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (la == 0) return;  // the same for the whole block; lb <= la
  load_e_padded<T, WN>(e_glob, e, n);
  __syncthreads();  // E is in place
  const T c = *c_ptr;
  if (warp == 0) {
    k3_alpha_warp<T, RN>(em, e, xrows, alpha_out, off_a, c, la, b, batch, n, lane);
  } else if (lb > 0) {
    k3_beta_warp<T, RN>(em, e, xrows + 2 * WN, beta_out, off_b, c, lb, b, batch, n, lane);
  }
}

// The log of K3's raw rows, frame-parallel: alpha = I + log s + o_a and
// beta = log y + o_b on the live rows, -inf on the others.
template <typename T>
__global__ void fcc_fwd_log_kernel(const T* __restrict__ em, const int* __restrict__ li,
                                   T* __restrict__ alpha, T* __restrict__ beta,
                                   const T* __restrict__ off_a, const T* __restrict__ off_b,
                                   int t_total, int batch, int n) {
  const size_t total = (size_t)t_total * batch * n;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const size_t row = idx / n;  // t * batch + b
    const int t = (int)(row / batch);
    const int L = li[row - (size_t)t * batch];
    const bool live_a = t < L;
    const bool live_b = t < L && L <= t_total;
    alpha[idx] = live_a ? (em[idx] + d_log(alpha[idx])) + off_a[row] : neg_inf<T>();
    beta[idx] = live_b ? d_log(beta[idx]) + off_b[row] : neg_inf<T>();
  }
}

// K4's warp route: one block of one warp per element walks K3's beta warp
// alone (k3_beta_warp), writing the raw rows y_t into ``beta_out`` and the
// per-frame offsets into off_b.  E sits in shared memory as in K3's route;
// one __syncwarp before the walk.  An element with L outside [1, T] has no
// beta and returns at once: every one of its rows, and the rows t >= L of
// the others, are fcc_beta_log_kernel's -inf.  Shared memory: one
// double-buffered row of WN words, then E (load_e_padded).
template <typename T, int RN>
__global__ void __launch_bounds__(32, 1) fcc_beta_warp_kernel(
    const T* __restrict__ em,       // (T, B, N) emissions
    const T* __restrict__ e_glob,   // (N, N) e[j*N + i] = exp(T[j][i] - c)
    const T* __restrict__ c_ptr,    // () the max finite transition
    const int* __restrict__ li,
    T* __restrict__ beta_out,       // (T, B, N)
    T* __restrict__ off_b,          // (T, B) per-frame offsets
    int t_total, int batch, int n) {
  constexpr int WN = 32 * RN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xrows = reinterpret_cast<T*>(smem_raw);
  T* e = xrows + 2 * WN;
  const int b = blockIdx.x;
  const int L = li[b];
  if (L < 1 || L > t_total) return;
  load_e_padded<T, WN>(e_glob, e, n);
  __syncwarp();  // E is in place
  k3_beta_warp<T, RN>(em, e, xrows, beta_out, off_b, *c_ptr, L, b, batch, n, threadIdx.x);
}

// The log of K4's raw rows, frame-parallel: beta = log y + o_b on the live
// rows (t < L, L in [1, T]), -inf on the others.
template <typename T>
__global__ void fcc_beta_log_kernel(const int* __restrict__ li, T* __restrict__ beta,
                                    const T* __restrict__ off_b, int t_total, int batch,
                                    int n) {
  const size_t total = (size_t)t_total * batch * n;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const size_t row = idx / n;  // t * batch + b
    const int t = (int)(row / batch);
    const int L = li[row - (size_t)t * batch];
    beta[idx] = t < L && L <= t_total ? d_log(beta[idx]) + off_b[row] : neg_inf<T>();
  }
}

constexpr int kPostWarps = 4;
constexpr int kPostFrames = 4;  // frames a warp takes per tile
constexpr int kTile = kPostWarps * kPostFrames;

// K5's frame t for one warp: the dI row, and the tile's rows u_t and v_t
// (both 0 at t = 0), WN words each, zero past N.
template <typename T, int RN>
__device__ __forceinline__ void k5_frame(
    const T* __restrict__ em, const T* __restrict__ alpha, const T* __restrict__ beta,
    T* __restrict__ gi_out, T* __restrict__ urow, T* __restrict__ vrow, int t, int b,
    int batch, int n, int lane, T gs, T c) {
  const size_t row = ((size_t)t * batch + b) * n;
  T a[RN], gam[RN];
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int k = lane + 32 * r;
    a[r] = k < n ? alpha[row + k] : neg_inf<T>();
    gam[r] = k < n ? a[r] + beta[row + k] : neg_inf<T>();
  }
  T mg = warp_max(lane_max(gam));
  mg = is_finite(mg) ? mg : T(0);
  T eg[RN], tot = T(0);
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    eg[r] = d_exp(gam[r] - mg);
    tot += eg[r];
  }
  tot = warp_sum(tot);
  const T inv = rcp(tot > T(0) ? tot : T(1));
  T gi[RN];
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    gi[r] = eg[r] * inv * gs;
    if (lane + 32 * r < n) gi_out[row + lane + 32 * r] = gi[r];
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      urow[lane + 32 * r] = T(0);
      vrow[lane + 32 * r] = T(0);
    }
    return;
  }
  const size_t prev = row - (size_t)batch * n;
  T ap[RN];
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int k = lane + 32 * r;
    ap[r] = k < n ? alpha[prev + k] : neg_inf<T>();
  }
  T mp = warp_max(lane_max(ap));
  mp = is_finite(mp) ? mp : T(0);
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int k = lane + 32 * r;
    const T ue = (k < n && is_finite(a[r])) ? em[row + k] - a[r] : neg_inf<T>();
    urow[k] = gi[r] * d_exp(ue + mp + c);
    vrow[k] = d_exp(ap[r] - mp);
  }
}

// K5's posterior kernel: one block per (element b = blockIdx.y, chunk
// blockIdx.x of ``chunk`` frames).  Writes the chunk's dI rows (zeros at
// t >= L, and everywhere for an element with L outside [1, T]) and its
// (N, N) partial part[p][i*N + j] = sum over the chunk's frames of
// u_t[i] v_t[j], p = b * chunks + blockIdx.x.  Shared memory: the (WN, WN)
// accumulator, then the tile's u and v rows, (kTile, WN) each.
template <typename T, int RN>
__global__ void __launch_bounds__(kPostWarps * 32) fcc_bwd_post_kernel(
    const T* __restrict__ em, const T* __restrict__ c_ptr, const int* __restrict__ li,
    const T* __restrict__ alpha, const T* __restrict__ beta, const T* __restrict__ g,
    T* __restrict__ gi_out, T* __restrict__ part, int t_total, int batch, int n,
    int chunk) {
  constexpr int WN = 32 * RN;
  constexpr int kThreads = kPostWarps * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // acc[i*WN + j]
  T* urow = acc + WN * WN;
  T* vrow = urow + kTile * WN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const size_t p = (size_t)b * gridDim.x + blockIdx.x;
  const int L = li[b];
  const int live = (L >= 1 && L <= t_total) ? L : 0;
  const int t_begin = blockIdx.x * chunk;
  const int t_stop = t_begin + chunk < t_total ? t_begin + chunk : t_total;
  const int t_end = live < t_stop ? live : t_stop;  // frames computed: [t_begin, t_end)

  // the dI rows past the live frames
  const int z0 = t_end > t_begin ? t_end : t_begin;
  for (int idx = tid; idx < (t_stop - z0) * n; idx += kThreads) {
    const int t = z0 + idx / n;
    gi_out[((size_t)t * batch + b) * n + idx % n] = T(0);
  }
  // thread tid owns the cells tid, tid + kThreads, ... of acc throughout
  for (int idx = tid; idx < WN * WN; idx += kThreads) acc[idx] = T(0);
  const T c = *c_ptr, gs = g[b];

  for (int t_tile = t_begin; t_tile < t_end; t_tile += kTile) {
    for (int q = 0; q < kPostFrames; ++q) {
      const int f = warp * kPostFrames + q;
      const int t = t_tile + f;
      if (t >= t_end) break;
      k5_frame<T, RN>(em, alpha, beta, gi_out, urow + f * WN, vrow + f * WN, t, b, batch,
                      n, lane, gs, c);
    }
    __syncthreads();  // the tile's rows are in place
    // acc[i][j] += the tile's frames, in order, of u_t[i] v_t[j]
    const int nf = t_end - t_tile < kTile ? t_end - t_tile : kTile;
    for (int idx = tid; idx < WN * WN; idx += kThreads) {
      const int i = idx / WN, j = idx - i * WN;
      T a = acc[idx];
      for (int f = 0; f < nf; ++f) a += urow[f * WN + i] * vrow[f * WN + j];
      acc[idx] = a;
    }
    __syncthreads();  // the next tile may overwrite the rows
  }

  T* part_p = part + p * n * n;
  for (int idx = tid; idx < WN * WN; idx += kThreads) {
    const int i = idx / WN, j = idx - i * WN;
    if (i < n && j < n) part_p[(size_t)i * n + j] = acc[idx];
  }
}

constexpr int kSumWarps = 32;

// K5's sums: dT for 32 cells a block (cell = i*N + j), warp w summing a
// fixed range of the partials in order, the warps' sums then combined in
// order: dT[i][j] = sum * E[i][j].
template <typename T>
__global__ void __launch_bounds__(kSumWarps * 32) fcc_bwd_sums_kernel(
    const T* __restrict__ part, const T* __restrict__ e_glob,  // E[i*N + j]
    T* __restrict__ d_trans, int nparts, int n) {
  __shared__ T red[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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

template <typename T, int RN>
int launch_fwd_warp_r(const T* em, const T* e, const T* c, const int* li, T* alpha,
                      T* beta, T* off, int t_total, int batch, int n, cudaStream_t st) {
  constexpr int WN = 32 * RN;
  const size_t smem = sizeof(T) * (size_t)(4 * WN + WN * (WN + 1));
  cudaError_t err = set_smem((const void*)fcc_fwd_warp_kernel<T, RN>, smem);
  if (err != cudaSuccess) return (int)err;
  T* off_b = off + (size_t)t_total * batch;
  fcc_fwd_warp_kernel<T, RN><<<batch, 64, smem, st>>>(em, e, c, li, alpha, beta, off,
                                                      off_b, t_total, batch, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)t_total * batch * n;
  const size_t blocks = (total + 255) / 256;
  fcc_fwd_log_kernel<T><<<(int)(blocks < 16 * 132 ? blocks : 16 * 132), 256, 0, st>>>(
      em, li, alpha, beta, off, off_b, t_total, batch, n);
  return (int)cudaGetLastError();
}

// RN = 1, 2 or 4 words a lane of each label row: N <= 128.
template <typename T>
int launch_fwd_warp(const T* em, const T* e, const T* c, const int* li, T* alpha,
                    T* beta, T* off, int t_total, int batch, int n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 32)
    return launch_fwd_warp_r<T, 1>(em, e, c, li, alpha, beta, off, t_total, batch, n, st);
  if (n <= 64)
    return launch_fwd_warp_r<T, 2>(em, e, c, li, alpha, beta, off, t_total, batch, n, st);
  if (n <= 128)
    return launch_fwd_warp_r<T, 4>(em, e, c, li, alpha, beta, off, t_total, batch, n, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int RN>
int launch_beta_warp_r(const T* em, const T* e, const T* c, const int* li, T* beta, T* off,
                       int t_total, int batch, int n, cudaStream_t st) {
  constexpr int WN = 32 * RN;
  const size_t smem = sizeof(T) * (size_t)(2 * WN + WN * (WN + 1));
  cudaError_t err = set_smem((const void*)fcc_beta_warp_kernel<T, RN>, smem);
  if (err != cudaSuccess) return (int)err;
  fcc_beta_warp_kernel<T, RN><<<batch, 32, smem, st>>>(em, e, c, li, beta, off, t_total,
                                                       batch, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)t_total * batch * n;
  const size_t blocks = (total + 255) / 256;
  fcc_beta_log_kernel<T><<<(int)(blocks < 16 * 132 ? blocks : 16 * 132), 256, 0, st>>>(
      li, beta, off, t_total, batch, n);
  return (int)cudaGetLastError();
}

// RN = 1, 2 or 4 words a lane of each label row: N <= 128.
template <typename T>
int launch_beta_warp(const T* em, const T* e, const T* c, const int* li, T* beta, T* off,
                     int t_total, int batch, int n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 32)
    return launch_beta_warp_r<T, 1>(em, e, c, li, beta, off, t_total, batch, n, st);
  if (n <= 64)
    return launch_beta_warp_r<T, 2>(em, e, c, li, beta, off, t_total, batch, n, st);
  if (n <= 128)
    return launch_beta_warp_r<T, 4>(em, e, c, li, beta, off, t_total, batch, n, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int RN>
int launch_bwd_warp_r(const T* em, const T* e, const T* c, const int* li, const T* alpha,
                      const T* beta, const T* g, T* gi, T* d_trans, T* part, int t_total,
                      int batch, int n, int chunk, cudaStream_t st) {
  constexpr int WN = 32 * RN;
  const size_t smem = sizeof(T) * (size_t)(WN * WN + 2 * kTile * WN);
  cudaError_t err = set_smem((const void*)fcc_bwd_post_kernel<T, RN>, smem);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (t_total + chunk - 1) / chunk;
  fcc_bwd_post_kernel<T, RN><<<dim3(nchunks, batch), kPostWarps * 32, smem, st>>>(
      em, c, li, alpha, beta, g, gi, part, t_total, batch, n, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fcc_bwd_sums_kernel<T><<<(n * n + 31) / 32, kSumWarps * 32, 0, st>>>(
      part, e, d_trans, nchunks * batch, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_warp(const T* em, const T* e, const T* c, const int* li, const T* alpha,
                    const T* beta, const T* g, T* gi, T* d_trans, T* part, int t_total,
                    int batch, int n, int chunk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  if (n <= 32)
    return launch_bwd_warp_r<T, 1>(em, e, c, li, alpha, beta, g, gi, d_trans, part,
                                   t_total, batch, n, chunk, st);
  if (n <= 64)
    return launch_bwd_warp_r<T, 2>(em, e, c, li, alpha, beta, g, gi, d_trans, part,
                                   t_total, batch, n, chunk, st);
  if (n <= 128)
    return launch_bwd_warp_r<T, 4>(em, e, c, li, alpha, beta, g, gi, d_trans, part,
                                   t_total, batch, n, chunk, st);
  return (int)cudaErrorInvalidValue;
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

// The warp routes.  K3: the block route's inputs without E^T, its outputs,
// then a (2, T, B) scratch for the per-frame offsets and the sizes.  K5:
// the block route's inputs, the outputs (dI, dT), the (chunks * B, N, N)
// partials, the sizes and the frames per chunk.

int fcc_fwd_warp_f32(const float* em, const float* e, const float* c, const int* li,
                     float* alpha, float* beta, float* off, int t_total, int batch, int n,
                     void* stream) {
  return launch_fwd_warp<float>(em, e, c, li, alpha, beta, off, t_total, batch, n, stream);
}

int fcc_fwd_warp_f64(const double* em, const double* e, const double* c, const int* li,
                     double* alpha, double* beta, double* off, int t_total, int batch,
                     int n, void* stream) {
  return launch_fwd_warp<double>(em, e, c, li, alpha, beta, off, t_total, batch, n, stream);
}

// K4's warp route: the block route's arguments, then a (T, B) scratch for
// the per-frame offsets, the sizes.

int fcc_beta_warp_f32(const float* em, const float* e, const float* c, const int* li,
                      float* beta, float* off, int t_total, int batch, int n,
                      void* stream) {
  return launch_beta_warp<float>(em, e, c, li, beta, off, t_total, batch, n, stream);
}

int fcc_beta_warp_f64(const double* em, const double* e, const double* c, const int* li,
                      double* beta, double* off, int t_total, int batch, int n,
                      void* stream) {
  return launch_beta_warp<double>(em, e, c, li, beta, off, t_total, batch, n, stream);
}

int fcc_bwd_warp_f32(const float* em, const float* e, const float* c, const int* li,
                     const float* alpha, const float* beta, const float* g, float* gi,
                     float* d_trans, float* part, int t_total, int batch, int n, int chunk,
                     void* stream) {
  return launch_bwd_warp<float>(em, e, c, li, alpha, beta, g, gi, d_trans, part, t_total,
                                batch, n, chunk, stream);
}

int fcc_bwd_warp_f64(const double* em, const double* e, const double* c, const int* li,
                     const double* alpha, const double* beta, const double* g, double* gi,
                     double* d_trans, double* part, int t_total, int batch, int n,
                     int chunk, void* stream) {
  return launch_bwd_warp<double>(em, e, c, li, alpha, beta, g, gi, d_trans, part, t_total,
                                 batch, n, chunk, stream);
}

}  // extern "C"
