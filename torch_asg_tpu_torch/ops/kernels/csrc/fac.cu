// The force-aligned (FAC) lattice's per-lattice kernels, log domain:
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
// What bounds them on an H100.  K6 and K7 are serial chains: each element
// takes T (K6) or L (K7) dependent steps of a few operations a slot; the
// bytes (each row read and written once) are far below what the card moves
// in that time, so the time is (steps) x (latency of one step).  K8 has no
// recurrence: frame t reads rows t of alpha, beta and A and row t-1 of
// alpha, and nothing carries from frame to frame but the two edge sums.
// Its bound is its bytes; a design that walks the frames in order pays a
// chain's latency for work with none.
//
// K6 has two routes with the same outputs, picked by the wrapper
// (common.py::width_route of the slot count):
//   - the warp route (S <= 128; lane l holds slots l, l+32, ..., RS = 1, 2
//     or 4 words of a row), which cuts the dependent chain by about a
//     factor K (K = kAlphaBlock = 4 frames, chosen from 2, 4 and 8 by timing
//     each in fp32 and fp64: PERF.md section 6).  A single-step chain, on a warp or on a block, pays
//     at least one log-add's dependent latency a frame (max, subtract,
//     exp, log, add), and K7's warp runs at about that pace (PERF.md
//     section 6).  Over a
//     block of K frames, the row at t0+K is a (K+1)-term log-sum-exp of
//     the row at t0:
//       alpha_{t0+K}[s] = LSE_i (alpha_{t0}[s-i] + W_{t0}[s, i]),
//     with W_{t0}[s, i] the log-sum of the paths from slot s-i at t0 to
//     slot s at t0+K with i advances, transitions and emissions included.
//     W does not depend on alpha, so it leaves the chain:
//     fac_alpha_band_kernel builds it by a small band recursion (O(K^2 S)
//     log-adds a block) over (element, chunk of blocks), sized by the
//     wrapper (common.py::post_chunk) to fill the SMs;
//     fac_alpha_warp_kernel, one warp per element, walks only the T/K
//     checkpoint rows: K shuffled copies of the row (independent, back to
//     back), one max tree, K+1 exps, one sum tree in a fixed order and one
//     log, so about one log-add's depth plus two trees for K frames; the
//     bands wait in a register ring several blocks deep, so the chain does
//     not wait on their loads.  One warp issues the chain's instructions in
//     order, so a step's cost is its instruction count as much as its
//     depth: the bands are laid out at the lane layout's padded width, a
//     block's loads are fixed offsets from one pointer, the block loop has
//     no exit inside its unrolled groups, and the fp32 exps and log run on
//     the SFU (chain_exp, chain_log).  fac_alpha_fill_kernel then
//     recomputes the rows between the checkpoints over (element, block) by
//     the one-step recursion.  The chain stays in the log domain; an
//     all--inf sum gives -inf, and no sum uses atomics, so two runs give
//     the same bits.
//   - the block route (S <= 512), as K7's block route below.
//
// K6's block route, and K7's (S <= 512), one block per element, one thread
// per slot:
//   - elements run side by side on separate SMs;
//   - a step exchanges the neighbouring slot's value through a shared row
//     with one barrier; the row is double-buffered, so a step's writes
//     never wait on the previous step's reads;
//   - the next step's rows are loaded into registers one step ahead.
// A step's pace is then the barrier and the shared-memory round trip
// around one log-add.
//
// K7 has two routes with the same outputs, picked by the wrapper
// (common.py::width_route of the slot count): the block route above, and
// the warp route (S <= 128), fac_beta_warp_kernel: one block of one warp
// per element walks the chain with no barrier at all, through K1's FAC
// warp (fac_warp in chain_common.cuh, with its row stores and without the
// score).  Lane l holds slots l, l+32, ... (RS = 1, 2 or 4 words); the
// neighbour comes from a warp shuffle, the log-add is written with selects,
// the aligned rows wait in a 4-deep register ring with the time loop
// unrolled by 4, and each row goes out as fire-and-forget stores of 32
// coalesced words.  The chain stays in the log domain: a FAC step is
// elementwise, and an exp-domain rescale would cost a warp max a step.  A
// step is then a shuffle and a log-add's dependent latency.  Measured, that
// step is close to the block route's (PERF.md section 6): the barrier was
// not what set the block route's pace, the log-add's dependent chain is.
//
// K8 has two routes with the same outputs, picked by the wrapper
// (common.py::width_route of the slot count):
//   - the warp route (S <= 128; lane l holds slots l, l+32, ..., RS = 1, 2
//     or 4 words of a row, a template parameter), K5's design:
//     fac_bwd_post_kernel runs one block of four warps per (element, chunk
//     of frames), sized by the wrapper (common.py::post_chunk) so that the
//     blocks fill the SMs.  A warp takes one frame at a time: the row max
//     and sum by warp shuffles, the dA row, and the frame's two edge terms
//     added into the lane's registers; alpha_{t-1} is read straight from
//     memory, at a chunk's first frame too, so no frame waits on another.
//     The four warps' sums are combined in warp order into the chunk's
//     (chunks, B, S) partials, and fac_bwd_sums_kernel sums those over
//     the chunks in order and applies gnext's shift.  No atomics: two runs
//     give the same bits.
//   - the block route (S <= 512): one block per element walks the frames in
//     order, one thread per slot, reading alpha_{t-1}[s-1] straight from
//     memory, with two barriers a step (the row max and the row sum); each
//     thread keeps its slot's two edge sums in registers over t, so they
//     are summed in a fixed order with no second kernel and no atomics.
// Both routes' times on an H100, K6's, K7's and K8's, are in PERF.md
// section 6 (chip_smoke.py).

#include "chain_common.cuh"

namespace {

constexpr int kMaxWarps = 16;  // 512 threads: the tier's width cap

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

// ------------------------------------------------------ K6's warp route

constexpr int kBandWarps = 4;

// Frames a block of K6's chain (the kernels' template parameter K): 4 ran
// fastest of 2, 4 and 8 in fp32 and in fp64 (scripts/fcc_diag.py
// --k6-variants builds the others).
constexpr int kAlphaBlock = 4;

// Blocks of bands in flight in K6's chain: a register ring of at most 96
// 32-bit words a lane, 1 to 8 blocks deep.
template <typename T, int RS, int K>
__host__ __device__ constexpr int alpha_ring() {
  constexpr int words = (K + 1) * RS * (int)(sizeof(T) / 4);
  return 96 / words < 1 ? 1 : (96 / words > 8 ? 8 : 96 / words);
}

// Frames in block j: min(K, T - 1 - jK); blocks: ceil((T - 1) / K).
template <int K>
__device__ __forceinline__ int block_steps(int j, int t_total) {
  const int left = t_total - 1 - j * K;
  return left < K ? left : K;
}

// The bands: (blocks + kBandSpare, B, K+1, 32 RS), each row padded to the
// lane layout's width (-inf past S), so that the chain reads a block's
// bands at fixed offsets from one pointer; the kBandSpare blocks at the end
// are never written: the chain runs whole groups of its ring's depth D, and
// its loads past the last block (up to 2D - 1 blocks) need no guard.
constexpr int kBandSpare = 16;

// K6's warp route, step 1: the bands, one block of kBandWarps warps per
// (element b = blockIdx.y, chunk blockIdx.x of ``chunk`` blocks of K
// frames), warp w taking the chunk's blocks j_begin + w, j_begin + w +
// kBandWarps, ...; lane l holds slots l, l+32, ...  For block j (t0 = jK,
// steps = min(K, T-1-t0)), from w[0] = 0 and w[i > 0] = -inf, m = 1 ..
// steps:
//   w[i][s] = A_{t0+m}[s] + logaddexp(w[i][s] + self[s], w[i-1][s-1] + next[s-1]),
// i = m .. 1 in descending order (each reads the old w[i-1]; rows i > m are
// still -inf), then w[0][s] += self[s] + A_{t0+m}[s].  The block's rows of
// A are loaded before the recursion starts.
template <typename T, int RS, int K>
__global__ void __launch_bounds__(kBandWarps * 32) fac_alpha_band_kernel(
    const T* __restrict__ al,      // (T, B, S)
    const T* __restrict__ self_t,  // (B, S)
    const T* __restrict__ next_t,  // (B, S)
    T* __restrict__ band,          // (blocks + kBandSpare, B, K+1, 32 RS)
    int t_total, int batch, int s, int chunk) {
  constexpr int WS = 32 * RS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int nblocks = (t_total - 1 + K - 1) / K;
  const int j_begin = blockIdx.x * chunk;
  const int j_stop = j_begin + chunk < nblocks ? j_begin + chunk : nblocks;
  T self_r[RS], next_l[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int k = lane + 32 * r;
    self_r[r] = k < s ? self_t[(size_t)b * s + k] : T(0);
    next_l[r] = (k >= 1 && k < s) ? next_t[(size_t)b * s + k - 1] : T(0);
  }
  for (int j = j_begin + warp; j < j_stop; j += kBandWarps) {
    const int t0 = j * K;
    const int steps = block_steps<K>(j, t_total);
    T a[K][RS];
#pragma unroll
    for (int m = 0; m < K; ++m) {
      if (m < steps) load_row(al + ((size_t)(t0 + 1 + m) * batch + b) * s, s, lane, a[m]);
    }
    T w[K + 1][RS];
#pragma unroll
    for (int i = 0; i <= K; ++i) {
#pragma unroll
      for (int r = 0; r < RS; ++r) w[i][r] = i == 0 ? T(0) : neg_inf<T>();
    }
#pragma unroll
    for (int m = 1; m <= K; ++m) {
      if (m > steps) break;
#pragma unroll
      for (int i = m; i >= 1; --i) {
        T up[RS], x[RS], y[RS];
        shift_up_slots<T, RS>(w[i - 1], 1, lane, up);
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          x[r] = w[i][r] + self_r[r];
          y[r] = up[r] + next_l[r];
        }
        log_add_row<T, RS>(x, y, w[i]);
#pragma unroll
        for (int r = 0; r < RS; ++r) w[i][r] = a[m - 1][r] + w[i][r];
      }
#pragma unroll
      for (int r = 0; r < RS; ++r) w[0][r] = a[m - 1][r] + (w[0][r] + self_r[r]);
    }
    T* out = band + ((size_t)j * batch + b) * (K + 1) * WS + lane;
#pragma unroll
    for (int i = 0; i <= K; ++i) {
#pragma unroll
      for (int r = 0; r < RS; ++r) out[i * WS + 32 * r] = w[i][r];
    }
  }
}

// The chain's exp and log.  fp32: the SFU's base-2 exp and log with
// denormals flushed (ex2.approx.ftz, lg2.approx.ftz), each a multiply away
// from e^x and ln x: 2 instructions where expf and logf take about 10 and
// 25, for a chain that one warp issues in order.  The flush matters too:
// __expf and __logf guard denormals with a predicate a call, and with the
// predicate registers taken by the chain's slot and shift masks, the
// compiler reuses one predicate for every guard and so runs the step's
// K+1 exps one after another (PERF.md section 6).  Their error stays far
// inside the fp32 rounding of alpha: exponents are <= 0, ex2.approx's
// relative error is about 2^-22 and the term's weight falls as e^x, a
// result below 2^-126 flushes to 0, and lg2.approx's error is about 2^-22
// absolute on sums in [1, K+1].  fp64: exp and log.  exp(-inf) = 0 and
// log(0) = -inf in both.
__device__ __forceinline__ float chain_exp(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}
__device__ __forceinline__ double chain_exp(double x) { return exp(x); }
__device__ __forceinline__ float chain_log(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r * 0.6931471805599453f;
}
__device__ __forceinline__ double chain_log(double x) { return log(x); }

// K6's warp route, step 2: the chain, one warp per element b = blockIdx.x
// walking the checkpoint rows alone.  From alpha_0 (A_0 at slot 0, -inf
// elsewhere), block j's last row t0 + steps is
//   alpha[s] = LSE_{i=0..K} (alpha_{t0}[s-i] + band_j[i][s]):
// K shifted copies of the row by independent shuffles, K+1 adds, a max
// tree, K+1 exps of exponents <= 0, a sum tree in a fixed order and one
// log, the R slots of a lane stage by stage; an all--inf sum gives -inf.
// Block j's bands wait in ring slot j % D (D = alpha_ring), loaded D block
// steps before their step from one pointer advanced a block a step, with
// the block loop unrolled by D; each row goes out as fire-and-forget
// stores.  A step's addresses are increments and fixed offsets: a single
// warp issues every instruction of the chain in order, so its integer
// work paces it as much as its arithmetic.  The loop runs whole groups of
// D blocks with no exit inside a group: the blocks past the last compute
// on the spare bands and store nothing.  (An exit inside the unrolled
// group made the compiler copy ring registers at each step, and a copy
// waits on its load: scripts/fcc_diag.py --k6-variants, PERF.md section 6.)
template <typename T, int RS, int K>
__global__ void __launch_bounds__(32, 1) fac_alpha_warp_kernel(
    const T* __restrict__ al,    // (T, B, S)
    const T* __restrict__ band,  // (blocks + kBandSpare, B, K+1, 32 RS)
    T* __restrict__ alpha_out,   // (T, B, S)
    int t_total, int batch, int s) {
  constexpr int D = alpha_ring<T, RS, K>();
  constexpr int WS = 32 * RS;
  static_assert(2 * D - 1 <= kBandSpare, "the look-ahead must stay inside the spare blocks");
  const int b = blockIdx.x, lane = threadIdx.x;
  const int nblocks = (t_total - 1 + K - 1) / K;
  const size_t block_stride = (size_t)batch * (K + 1) * WS;  // one block's bands
  const size_t row_stride = (size_t)batch * s;               // one frame's row
  const T* wb = band + (size_t)b * (K + 1) * WS + lane;      // block 0, lane's word 0
  T* out = alpha_out + (size_t)b * s + lane;                 // frame 0, lane's word 0
  bool has[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) has[r] = lane + 32 * r < s;
  T a[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    a[r] = lane + 32 * r == 0 ? al[(size_t)b * s] : neg_inf<T>();
    if (has[r]) out[32 * r] = a[r];
  }
  T ring[D][K + 1][RS];
#pragma unroll
  for (int u = 0; u < D; ++u) {
#pragma unroll
    for (int i = 0; i <= K; ++i) {
#pragma unroll
      for (int r = 0; r < RS; ++r) ring[u][i][r] = wb[i * WS + 32 * r];
    }
    wb += block_stride;
  }

  for (int j0 = 0; j0 < nblocks; j0 += D) {
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int j = j0 + u;
      T x[K + 1][RS];
#pragma unroll
      for (int i = 1; i <= K; ++i) shift_up_slots<T, RS>(a, i, lane, x[i]);
#pragma unroll
      for (int r = 0; r < RS; ++r) x[0][r] = a[r] + ring[u][0][r];
#pragma unroll
      for (int i = 1; i <= K; ++i) {
#pragma unroll
        for (int r = 0; r < RS; ++r) x[i][r] += ring[u][i][r];
      }
      // block j + D's bands into the slot just read (past the last block:
      // the spare blocks, never consumed)
#pragma unroll
      for (int i = 0; i <= K; ++i) {
#pragma unroll
        for (int r = 0; r < RS; ++r) ring[u][i][r] = wb[i * WS + 32 * r];
      }
      wb += block_stride;

      T m[RS];
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        T v[K + 1];
#pragma unroll
        for (int i = 0; i <= K; ++i) v[i] = x[i][r];
        m[r] = tree_reduce<true>(v);
        m[r] = m[r] > neg_inf<T>() ? m[r] : T(0);
      }
#pragma unroll
      for (int i = 0; i <= K; ++i) {
#pragma unroll
        for (int r = 0; r < RS; ++r) x[i][r] = chain_exp(x[i][r] - m[r]);
      }
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        T v[K + 1];
#pragma unroll
        for (int i = 0; i <= K; ++i) v[i] = x[i][r];
        a[r] = m[r] + chain_log(tree_reduce<false>(v));
      }
      const int t = j * K + K < t_total ? j * K + K : t_total - 1;
      T* row = out + (size_t)t * row_stride;
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        if (has[r] && j < nblocks) row[32 * r] = a[r];
      }
    }
  }
}

// K6's warp route, step 3: the fill, on the bands' grid.  Block j's rows
// t0+1 .. t0+steps-1 from the chain's checkpoint row t0 by the one-step
// recursion; row t0 + steps is the chain's.
template <typename T, int RS, int K>
__global__ void __launch_bounds__(kBandWarps * 32) fac_alpha_fill_kernel(
    const T* __restrict__ al,      // (T, B, S)
    const T* __restrict__ self_t,  // (B, S)
    const T* __restrict__ next_t,  // (B, S)
    T* __restrict__ alpha,         // (T, B, S)
    int t_total, int batch, int s, int chunk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int nblocks = (t_total - 1 + K - 1) / K;
  const int j_begin = blockIdx.x * chunk;
  const int j_stop = j_begin + chunk < nblocks ? j_begin + chunk : nblocks;
  T self_r[RS], next_l[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int k = lane + 32 * r;
    self_r[r] = k < s ? self_t[(size_t)b * s + k] : T(0);
    next_l[r] = (k >= 1 && k < s) ? next_t[(size_t)b * s + k - 1] : T(0);
  }
  for (int j = j_begin + warp; j < j_stop; j += kBandWarps) {
    const int t0 = j * K;
    const int steps = block_steps<K>(j, t_total);
    T av[K - 1][RS];
#pragma unroll
    for (int m = 1; m < K; ++m) {
      if (m < steps) load_row(al + ((size_t)(t0 + m) * batch + b) * s, s, lane, av[m - 1]);
    }
    T a[RS];
    load_row(alpha + ((size_t)t0 * batch + b) * s, s, lane, a);
#pragma unroll
    for (int m = 1; m < K; ++m) {
      if (m >= steps) break;
      T up[RS], x[RS], y[RS];
      shift_up_slots<T, RS>(a, 1, lane, up);
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        x[r] = a[r] + self_r[r];
        y[r] = up[r] + next_l[r];
      }
      log_add_row<T, RS>(x, y, a);
#pragma unroll
      for (int r = 0; r < RS; ++r) a[r] = av[m - 1][r] + a[r];
      store_row(alpha + ((size_t)(t0 + m) * batch + b) * s, s, lane, a);
    }
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

// K7's warp route: one block of one warp per element, walking the beta
// chain alone with fac_warp (chain_common.cuh, K1's FAC warp) storing every
// row qb_t, t = L-1 .. 0, and no score.  The rows t >= L, and every row of
// an element with L outside [1, T], are -inf, written first by the same
// warp (fire-and-forget rows); such an element returns before the walk.
template <typename T, int RS>
__global__ void __launch_bounds__(32, 1) fac_beta_warp_kernel(
    const T* __restrict__ al,      // (T, B, S)
    const T* __restrict__ self_t,  // (B, S)
    const T* __restrict__ next_t,  // (B, S)
    const int* __restrict__ li, const int* __restrict__ lo,
    T* __restrict__ beta_out,      // (T, B, S)
    int t_total, int batch, int s) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int L = li[b];
  const int lb = (L >= 1 && L <= t_total) ? L : 0;
  for (int t = lb; t < t_total; ++t) {
    T* row = beta_out + ((size_t)t * batch + b) * s;
    for (int k = lane; k < s; k += 32) row[k] = neg_inf<T>();
  }
  if (lb == 0) return;
  fac_warp<T, true, RS, false>(al, self_t, next_t, beta_out, nullptr, lb, lo[b], b, batch,
                               s, lane);
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

constexpr int kPostWarps = 4;

// K8's warp route, the posterior kernel: one block per (element b =
// blockIdx.y, chunk blockIdx.x of ``chunk`` frames), warp w taking the
// chunk's frames t_begin + w, t_begin + w + kPostWarps, ...  Writes the
// chunk's dA rows and its edge sums over its frames t >= 1 into
// part_self and part_diag, (chunks, B, S) each.
template <typename T, int RS>
__global__ void __launch_bounds__(kPostWarps * 32) fac_bwd_post_kernel(
    const T* __restrict__ al,      // (T, B, S)
    const T* __restrict__ self_t,  // (B, S)
    const T* __restrict__ next_t,  // (B, S)
    const T* __restrict__ alpha,   // (T, B, S)
    const T* __restrict__ beta,    // (T, B, S)
    const T* __restrict__ g,       // (B,)
    T* __restrict__ gi_out,        // (T, B, S)
    T* __restrict__ part_self, T* __restrict__ part_diag,  // (chunks, B, S)
    int t_total, int batch, int s, int chunk) {
  constexpr int WS = 32 * RS;
  __shared__ T red[2][kPostWarps][WS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int t_begin = blockIdx.x * chunk;
  const int t_stop = t_begin + chunk < t_total ? t_begin + chunk : t_total;
  const T ninf = neg_inf<T>();
  T self_k[RS], next_l[RS], acc_self[RS], acc_diag[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int k = lane + 32 * r;
    self_k[r] = k < s ? self_t[(size_t)b * s + k] : T(0);
    next_l[r] = (k >= 1 && k < s) ? next_t[(size_t)b * s + k - 1] : T(0);
    acc_self[r] = T(0);
    acc_diag[r] = T(0);
  }
  const T gs = g[b];

  for (int t = t_begin + warp; t < t_stop; t += kPostWarps) {
    const size_t row = ((size_t)t * batch + b) * s;
    T a[RS], gam[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int k = lane + 32 * r;
      a[r] = k < s ? alpha[row + k] : ninf;
      gam[r] = k < s ? a[r] + beta[row + k] : ninf;
    }
    T m = warp_max(lane_max(gam));
    m = is_finite(m) ? m : T(0);
    T e[RS], tot = T(0);
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      e[r] = d_exp(gam[r] - m);
      tot += e[r];
    }
    tot = warp_sum(tot);
    const T inv = rcp(tot > T(0) ? tot : T(1));
    T gi[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      gi[r] = e[r] * inv * gs;
      if (lane + 32 * r < s) gi_out[row + lane + 32 * r] = gi[r];
    }
    if (t == 0) continue;
    // the edge fractions into frame t: alpha_{t-1} read from memory
    const size_t prev = row - (size_t)batch * s;
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int k = lane + 32 * r;
      if (k < s) {
        const T sub = is_finite(a[r]) ? al[row + k] - a[r] : ninf;
        // slot 0 has only the self-loop in-edge, fraction 1
        const T hori = k == 0 ? T(1) : d_exp(alpha[prev + k] + self_k[r] + sub);
        const T diag = d_exp((k >= 1 ? alpha[prev + k - 1] + next_l[r] : ninf) + sub);
        acc_self[r] += gi[r] * hori;
        acc_diag[r] += gi[r] * diag;
      }
    }
  }
  // the chunk's sums: the warps' in warp order
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    red[0][warp][lane + 32 * r] = acc_self[r];
    red[1][warp][lane + 32 * r] = acc_diag[r];
  }
  __syncthreads();
  const size_t p = ((size_t)blockIdx.x * batch + b) * s;
  for (int k = threadIdx.x; k < s; k += kPostWarps * 32) {
    T sum_self = red[0][0][k], sum_diag = red[1][0][k];
#pragma unroll
    for (int w = 1; w < kPostWarps; ++w) {
      sum_self += red[0][w][k];
      sum_diag += red[1][w][k];
    }
    part_self[p + k] = sum_self;
    part_diag[p + k] = sum_diag;
  }
}

// K8's warp route, the sums: one thread per (element, slot) cell sums the
// chunks' partials in chunk order; gnext[s] = gdiag[s+1], 0 at s = S-1.
template <typename T>
__global__ void fac_bwd_sums_kernel(const T* __restrict__ part_self,
                                    const T* __restrict__ part_diag,
                                    T* __restrict__ gself, T* __restrict__ gnext,
                                    int nchunks, int batch, int s) {
  const int cells = batch * s;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const bool shifted = cell % s + 1 < s;
  T sum_self = T(0), sum_diag = T(0);
  for (int c = 0; c < nchunks; ++c) {
    const size_t at = (size_t)c * cells + cell;
    sum_self += part_self[at];
    if (shifted) sum_diag += part_diag[at + 1];
  }
  gself[cell] = sum_self;
  gnext[cell] = sum_diag;
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

template <typename T, int RS, int K>
int launch_alpha_warp_rk(const T* al, const T* self_t, const T* next_t, T* alpha, T* band,
                         int t_total, int batch, int s, int chunk, cudaStream_t st) {
  const int nblocks = (t_total - 1 + K - 1) / K;
  const dim3 grid((nblocks + chunk - 1) / chunk, batch);
  cudaError_t err;
  if (nblocks > 0) {
    fac_alpha_band_kernel<T, RS, K><<<grid, kBandWarps * 32, 0, st>>>(
        al, self_t, next_t, band, t_total, batch, s, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  fac_alpha_warp_kernel<T, RS, K><<<batch, 32, 0, st>>>(al, band, alpha, t_total, batch, s);
  err = cudaGetLastError();
  if (err != cudaSuccess || nblocks == 0) return (int)err;
  fac_alpha_fill_kernel<T, RS, K><<<grid, kBandWarps * 32, 0, st>>>(
      al, self_t, next_t, alpha, t_total, batch, s, chunk);
  return (int)cudaGetLastError();
}

// RS = 1, 2 or 4 words a lane of each slot row: S <= 128.
template <typename T>
int launch_alpha_warp(const T* al, const T* self_t, const T* next_t, T* alpha, T* band,
                      int t_total, int batch, int s, int chunk, void* stream) {
  constexpr int K = kAlphaBlock;
  cudaStream_t st = (cudaStream_t)stream;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  if (s <= 32)
    return launch_alpha_warp_rk<T, 1, K>(al, self_t, next_t, alpha, band, t_total, batch, s,
                                         chunk, st);
  if (s <= 64)
    return launch_alpha_warp_rk<T, 2, K>(al, self_t, next_t, alpha, band, t_total, batch, s,
                                         chunk, st);
  if (s <= 128)
    return launch_alpha_warp_rk<T, 4, K>(al, self_t, next_t, alpha, band, t_total, batch, s,
                                         chunk, st);
  return (int)cudaErrorInvalidValue;
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

// RS = 1, 2 or 4 words a lane of each slot row: S <= 128.
template <typename T>
int launch_beta_warp(const T* al, const T* self_t, const T* next_t, const int* li,
                     const int* lo, T* beta, int t_total, int batch, int s, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (s <= 32) {
    fac_beta_warp_kernel<T, 1><<<batch, 32, 0, st>>>(al, self_t, next_t, li, lo, beta,
                                                      t_total, batch, s);
  } else if (s <= 64) {
    fac_beta_warp_kernel<T, 2><<<batch, 32, 0, st>>>(al, self_t, next_t, li, lo, beta,
                                                      t_total, batch, s);
  } else if (s <= 128) {
    fac_beta_warp_kernel<T, 4><<<batch, 32, 0, st>>>(al, self_t, next_t, li, lo, beta,
                                                      t_total, batch, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
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

template <typename T, int RS>
int launch_bwd_warp_r(const T* al, const T* self_t, const T* next_t, const T* alpha,
                      const T* beta, const T* g, T* gi, T* gself, T* gnext, T* part,
                      int t_total, int batch, int s, int chunk, cudaStream_t st) {
  const int nchunks = (t_total + chunk - 1) / chunk;
  T* part_diag = part + (size_t)nchunks * batch * s;
  fac_bwd_post_kernel<T, RS><<<dim3(nchunks, batch), kPostWarps * 32, 0, st>>>(
      al, self_t, next_t, alpha, beta, g, gi, part, part_diag, t_total, batch, s, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cells = batch * s;
  fac_bwd_sums_kernel<T><<<(cells + 127) / 128, 128, 0, st>>>(part, part_diag, gself, gnext,
                                                               nchunks, batch, s);
  return (int)cudaGetLastError();
}

// RS = 1, 2 or 4 words a lane of each slot row: S <= 128.
template <typename T>
int launch_bwd_warp(const T* al, const T* self_t, const T* next_t, const T* alpha,
                    const T* beta, const T* g, T* gi, T* gself, T* gnext, T* part,
                    int t_total, int batch, int s, int chunk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  if (s <= 32)
    return launch_bwd_warp_r<T, 1>(al, self_t, next_t, alpha, beta, g, gi, gself, gnext,
                                   part, t_total, batch, s, chunk, st);
  if (s <= 64)
    return launch_bwd_warp_r<T, 2>(al, self_t, next_t, alpha, beta, g, gi, gself, gnext,
                                   part, t_total, batch, s, chunk, st);
  if (s <= 128)
    return launch_bwd_warp_r<T, 4>(al, self_t, next_t, alpha, beta, g, gi, gself, gnext,
                                   part, t_total, batch, s, chunk, st);
  return (int)cudaErrorInvalidValue;
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

// K6's warp route: the block route's arguments, then a (blocks + 16, B, 5,
// 32 RS) scratch for the bands (K = 4 frames a block, blocks = ceil((T - 1)
// / K); RS = 1, 2 or 4 for S <= 32, 64, 128), the sizes and the blocks a
// chunk of the band and fill kernels.

int fac_alpha_warp_f32(const float* al, const float* self_t, const float* next_t,
                       float* alpha, float* band, int t_total, int batch, int s, int chunk,
                       void* stream) {
  return launch_alpha_warp<float>(al, self_t, next_t, alpha, band, t_total, batch, s, chunk,
                                  stream);
}

int fac_alpha_warp_f64(const double* al, const double* self_t, const double* next_t,
                       double* alpha, double* band, int t_total, int batch, int s, int chunk,
                       void* stream) {
  return launch_alpha_warp<double>(al, self_t, next_t, alpha, band, t_total, batch, s, chunk,
                                   stream);
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

// K7's warp route: the block route's arguments.

int fac_beta_warp_f32(const float* al, const float* self_t, const float* next_t,
                      const int* li, const int* lo, float* beta, int t_total, int batch,
                      int s, void* stream) {
  return launch_beta_warp<float>(al, self_t, next_t, li, lo, beta, t_total, batch, s,
                                 stream);
}

int fac_beta_warp_f64(const double* al, const double* self_t, const double* next_t,
                      const int* li, const int* lo, double* beta, int t_total, int batch,
                      int s, void* stream) {
  return launch_beta_warp<double>(al, self_t, next_t, li, lo, beta, t_total, batch, s,
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

// K8's warp route: the block route's arguments, then a (2, chunks, B, S)
// scratch for the partials, the sizes and the frames per chunk.

int fac_bwd_warp_f32(const float* al, const float* self_t, const float* next_t,
                     const float* alpha, const float* beta, const float* g, float* gi,
                     float* gself, float* gnext, float* part, int t_total, int batch, int s,
                     int chunk, void* stream) {
  return launch_bwd_warp<float>(al, self_t, next_t, alpha, beta, g, gi, gself, gnext, part,
                                t_total, batch, s, chunk, stream);
}

int fac_bwd_warp_f64(const double* al, const double* self_t, const double* next_t,
                     const double* alpha, const double* beta, const double* g, double* gi,
                     double* gself, double* gnext, double* part, int t_total, int batch,
                     int s, int chunk, void* stream) {
  return launch_bwd_warp<double>(al, self_t, next_t, alpha, beta, g, gi, gself, gnext, part,
                                 t_total, batch, s, chunk, stream);
}

}  // extern "C"
