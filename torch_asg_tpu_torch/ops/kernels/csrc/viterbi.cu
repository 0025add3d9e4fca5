// 1-best Viterbi decoding in the tropical (max) semiring: the forward pass
// with backpointers (kernel K10) and the backtrace (kernel K11).
//
// Replaces: torch_asg_tpu/ops/pallas/viterbi_kernels.py::_vit_kernel
// (launched by viterbi_forward_pallas) and ::_bt_kernel (launched by
// viterbi_backtrace_pallas).  Their outputs are the contract; the TPU
// rotation trick with its duplicated-lane carry does not carry over.
//
// K10, for element b with L = L_in[b], emissions masked to -inf at t >= L:
//   d_0 = I_0, backptr[0][i] = i (identity row, never read by the backtrace);
//   for t >= 1: best_i = max_j T[i,j] + d_{t-1}[j], backptr[t][i] = the
//   lowest j reaching it (strict > over ascending j), d_t = I_t + best;
//   d_end = d_{L-1} (-inf when L is outside [1, T]).
//   Max-plus is exact, so scores and backpointers are bit-identical to the
//   plain PyTorch version.
// K11: path[t] = final at t = L-1 (as given, whatever its range),
//   backptr[t+1][p] with p = max(path[t+1], 0) before it, or 0 where p >= N
//   (the JAX kernel's one-hot select finds no lane there), -1 after it (and
//   at t = T-1 unless L = T; for L > T the walk starts from -1 at T-1).
//
// What bounds them on an H100: the serial chains.  K10 takes T dependent
// steps of an N x N max-plus product (no tensor-core form); K11 takes T
// dependent lookups.  Bytes and operations are far below what the card does
// in that time.  Only d_t waits on d_{t-1}: the backpointers are work that
// no later step needs.
//
// K10 has two routes with the same outputs, picked by the wrapper
// (common.py::width_route of the label count):
//   - the warp route (N <= 128; lane l holds labels l, l+32, ..., RN = 1,
//     2 or 4 words of a row, a template parameter).  viterbi_fwd_warp_kernel:
//     one warp per element walks its live frames computing d_t = I_t +
//     max_j (T[i,j] + d_{t-1}[j]) and nothing else, and writes each d_t
//     into a (T, B, N) scratch.  A step is K3's warp step: the row through
//     a double-buffered shared row with one __syncwarp, read back as
//     broadcasts four words a load, into four partial maxes (each a chain
//     a quarter as long) combined at the end; the transition's columns sit
//     in registers at N <= 32 and in shared memory past it; the emission
//     rows wait in a register ring kDepth = 4 frames deep, with the time
//     loop unrolled by 4.  viterbi_bp_kernel, parallel over (element,
//     chunk of frames), one warp a frame with the chain's lane layout,
//     then recomputes each candidate T[i,j] + d_{t-1}[j] from the scratch,
//     in the same dtype by the same single add, and takes the lowest j
//     reaching the max.  Max-plus is exact, so the pass meets
//     the chain's maximum bit for bit: the backpointers equal the plain
//     version's.  Frames t with t-1 >= L hold d_{t-1} = -inf, every
//     candidate ties at -inf, and the pass writes 0 there without reading.
//   - the block route (N <= 1024): one block per element, one thread per
//     destination label; the transposed transition sits in shared memory
//     when it fits (thread i reads column i, conflict-free), the carry d in
//     shared memory, and the next emission row is loaded before the step's
//     max-plus loop so its latency overlaps it.  Two barriers a step.
// K11 and K13 (below) have two routes each with the same outputs, picked
// by the wrapper (common.py::width_route of the label or slot count):
//   - the warp route (width <= 128; lane l holds words l, l+32, ..., RW =
//     1, 2 or 4 of a row, a template parameter), backtrace_warp: one warp
//     per element walks t = min(L, T) - 2 .. 0 with no barrier.  A step is
//     s = max(x, 0), the lanes' word s >> 5 (0 past the last), one shuffle
//     from lane s & 31, and x = that value (K11) or s minus it (K13).
//     Lanes past the width hold 0, so the "0 outside [0, width)" rule costs
//     nothing on the chain.  The rows wait in a register ring of
//     backtrace_ring = 16-32 frames, walked downward with pointer
//     decrements, each load refilling the slot its step has just read; the
//     time loop is unrolled by the ring's depth with no exit inside a group
//     and no condition on a load (the steps past frame 0 read row 1 again
//     and store nothing).  Each step's value is stored by lane 0,
//     fire-and-forget, off the dependent path.  Frames min(L, T)-1 .. T-1
//     (the start value, then -1) are written before the walk, off the chain.
//   - the block route (any width): one block per element copies a chunk of
//     rows into shared memory with coalesced loads, then one thread walks
//     the chunk, so each dependent lookup costs a shared-memory read and
//     not a global-memory round trip.
// Both routes' times on an H100 are in PERF.md section 6 (chip_smoke.py).
//
// Forced alignment in the same semiring: the forward with one advance bit
// per slot (kernel K12) and its backtrace (kernel K13).
//
// Replaces: torch_asg_tpu/ops/pallas/viterbi_kernels.py::_alignf_kernel
// (launched by align_forward_pallas) and ::_albt_kernel (launched by
// align_backtrace_pallas).
//
// K12, for element b over the aligned lattice (emissions A (T, B, S), -inf
// outside t < L_in and s < L_out; self/next transitions (B, S)):
//   d_0 = A_0 at slot 0 only (-inf elsewhere), adv[0] = 0 (never read);
//   for t >= 1: stay = d_{t-1}[s] + self[s], move = d_{t-1}[s-1] + next[s-1]
//   (-inf at s = 0), d_t = A_t + max(stay, move), adv[t][s] = move > stay
//   (a tie stays); d_end = d_{L-1} (-inf when L is outside [1, T]).
//   Every frame is computed, so the advance bits past L_in equal the plain
//   version's too.  Max-plus is exact: bit-identical to the plain version.
// K13: pos[T-1] = L_out-1 if L = T else -1; for t < T-1, pos[t] = L_out-1 at
//   t = L-1, p - adv[t+1][p] with p = max(pos[t+1], 0) before it (no step
//   back when p >= S; adv values other than 0 and 1 are subtracted as
//   given), -1 after it.
//
// What bounds them: the serial chain again, two candidates a step instead
// of N, so a step is a few dependent operations; K13 is K11's walk over the
// advance bits, on the same two routes.  K12 has two routes with the same
// outputs, picked by the wrapper (common.py::width_route of the slot count):
//   - the warp route (S <= 128; lane l holds slots l, l+32, ..., RS = 1, 2
//     or 4 words of a row, a template parameter), align_forward_warp_kernel:
//     one warp per element walks the chain with no barrier.  A step takes
//     slot s-1's value by one shuffle a register (shift_up_slots; slot
//     32r's from lane 31 of register r-1), then stay, move, one compare and
//     one select: the block route's arithmetic, so the bits and rows are
//     the same.  The
//     compare's bit is stored straight from the chain, fire-and-forget, as
//     it lies off the dependent path.  At a few tens of nanoseconds a step,
//     the aligned rows must be asked for far ahead: they wait in a register
//     ring of align_ring = 16-32 frames (about 0.5-1 us of steps), with the
//     time loop unrolled by the ring's depth, each load refilling the slot
//     its step has just read.  A single warp issues every instruction in
//     order, so the step's integer work counts as much as its arithmetic:
//     its addresses are pointer increments.  The chain walks t = 1 .. L - 1
//     (L clipped to T) and then row L from d_{L-1}: A is -inf from frame L
//     on (make_aligned's mask), so d_t is -inf there and every bit past row
//     L is 0, while row L can hold a 1.  Row 0 and the rows past L are
//     written as zeros before the walk, off the chain.
//   - the block route (S <= 512): one block per element and one thread per
//     slot, with the carry in shared memory and two barriers a step; the
//     next frame's emission is loaded before the step's barrier.

#include "chain_common.cuh"

namespace {

constexpr size_t kSmemLimit = 227 * 1024;

template <typename T>
__global__ void viterbi_forward_kernel(
    const T* __restrict__ tt_glob,  // (N, N) transposed transition, tt[j*N + i] = T[i, j]
    const T* __restrict__ em,       // (T, B, N) emissions
    const int* __restrict__ li,     // (B,)
    int* __restrict__ bp,           // (T, B, N) backpointers
    T* __restrict__ dend,           // (B, N) end rows
    int t_total, int batch, int n, int tt_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* d_s = reinterpret_cast<T*>(smem_raw);
  T* tt_sm = d_s + n;

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int L = li[b];
  const bool lab = i < n;

  const T* tt = tt_glob;
  if (tt_in_smem) {
    for (int idx = i; idx < n * n; idx += blockDim.x) tt_sm[idx] = tt_glob[idx];
    tt = tt_sm;
  }

  T e = (lab && 0 < L) ? em[(size_t)b * n + i] : neg_inf<T>();
  if (lab) {
    d_s[i] = e;
    bp[(size_t)b * n + i] = i;
    dend[(size_t)b * n + i] = (L - 1 == 0) ? e : neg_inf<T>();
  }
  __syncthreads();

  for (int t = 1; t < t_total; ++t) {
    const size_t row = (size_t)t * batch + b;
    e = (lab && t < L) ? em[row * n + i] : neg_inf<T>();
    T d_new = neg_inf<T>();
    if (lab) {
      T best = tt[i] + d_s[0];
      int arg = 0;
      for (int j = 1; j < n; ++j) {
        const T c = tt[(size_t)j * n + i] + d_s[j];
        if (c > best) {
          best = c;
          arg = j;
        }
      }
      bp[row * n + i] = arg;
      d_new = e + best;
    }
    __syncthreads();
    if (lab) {
      d_s[i] = d_new;
      if (t == L - 1) dend[(size_t)b * n + i] = d_new;
    }
    __syncthreads();
  }
}

// Shared memory: rows[tc * N] (backpointer rows of frames t0+1 .. t0+tc),
// out[tc] (the chunk's path).
__global__ void viterbi_backtrace_kernel(
    const int* __restrict__ bp,     // (T, B, N)
    const int* __restrict__ fin,    // (B,) final labels
    const int* __restrict__ li,     // (B,)
    int* __restrict__ path,         // (T, B)
    int t_total, int batch, int n, int tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* rows = reinterpret_cast<int*>(smem_raw);
  int* out = rows + (size_t)tc * n;

  const int b = blockIdx.x;
  const int L = li[b];
  const int final_lab = fin[b];
  int lab = -1;  // thread 0's walk state: the label at frame t+1

  for (int t1 = t_total; t1 > 0; t1 -= tc) {
    const int t0 = t1 > tc ? t1 - tc : 0;
    // frames t that follow a backpointer: t < L-1 and t+1 < T
    int hi = t1;
    if (hi > L - 1) hi = L - 1;
    if (hi > t_total - 1) hi = t_total - 1;
    const int cnt = hi - t0;
    for (int idx = threadIdx.x; idx < cnt * n; idx += blockDim.x) {
      const int r = idx / n, c = idx - r * n;
      rows[idx] = bp[((size_t)(t0 + r + 1) * batch + b) * n + c];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int t = t1 - 1; t >= t0; --t) {
        if (t == L - 1) {
          lab = final_lab;
        } else if (t < L - 1 && t < t_total - 1) {
          const int from = lab < 0 ? 0 : lab;
          lab = from < n ? rows[(size_t)(t - t0) * n + from] : 0;
        } else {
          lab = -1;
        }
        out[t - t0] = lab;
      }
    }
    __syncthreads();
    for (int t = t0 + threadIdx.x; t < t1; t += blockDim.x)
      path[(size_t)t * batch + b] = out[t - t0];
    __syncthreads();
  }
}

template <typename T>
__global__ void align_forward_kernel(
    const T* __restrict__ ap,       // (T, B, S) aligned emissions
    const T* __restrict__ self_tr,  // (B, S) stay transitions
    const T* __restrict__ next_tr,  // (B, S) advance transitions, slot s -> s+1
    const int* __restrict__ li,     // (B,)
    int* __restrict__ adv,          // (T, B, S) advance bits
    T* __restrict__ dend,           // (B, S) end rows
    int t_total, int batch, int s_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* d_s = reinterpret_cast<T*>(smem_raw);

  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int L = li[b];
  const bool slot = s < s_total;
  const size_t bs = (size_t)b * s_total + s;
  const T stay_tr = slot ? self_tr[bs] : T(0);
  const T move_tr = (slot && s > 0) ? next_tr[bs - 1] : T(0);

  T d = (slot && s == 0) ? ap[bs] : neg_inf<T>();
  T d_end = (L - 1 == 0) ? d : neg_inf<T>();
  if (slot) {
    d_s[s] = d;
    adv[bs] = 0;
  }
  T a_next = (slot && t_total > 1) ? ap[(size_t)batch * s_total + bs] : neg_inf<T>();
  __syncthreads();

  for (int t = 1; t < t_total; ++t) {
    const T a = a_next;
    if (slot && t + 1 < t_total) a_next = ap[(size_t)(t + 1) * batch * s_total + bs];
    T d_new = neg_inf<T>();
    if (slot) {
      const T stay = d_s[s] + stay_tr;
      const T move = s > 0 ? d_s[s - 1] + move_tr : neg_inf<T>();
      const bool advanced = move > stay;
      d_new = a + (advanced ? move : stay);
      adv[(size_t)t * batch * s_total + bs] = advanced ? 1 : 0;
    }
    __syncthreads();
    if (slot) {
      d_s[s] = d_new;
      if (t == L - 1) d_end = d_new;
    }
    __syncthreads();
  }
  if (slot) dend[bs] = d_end;
}

// Shared memory: rows[tc * S] (advance-bit rows of frames t0+1 .. t0+tc),
// out[tc] (the chunk's positions).
__global__ void align_backtrace_kernel(
    const int* __restrict__ adv,    // (T, B, S)
    const int* __restrict__ end_s,  // (B,) L_out - 1
    const int* __restrict__ li,     // (B,)
    int* __restrict__ pos_out,      // (T, B)
    int t_total, int batch, int s_total, int tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* rows = reinterpret_cast<int*>(smem_raw);
  int* out = rows + (size_t)tc * s_total;

  const int b = blockIdx.x;
  const int L = li[b];
  const int es = end_s[b];
  int pos = -1;  // thread 0's walk state: the position at frame t+1

  for (int t1 = t_total; t1 > 0; t1 -= tc) {
    const int t0 = t1 > tc ? t1 - tc : 0;
    // frames t that read an advance bit: t < L-1 and t+1 < T
    int hi = t1;
    if (hi > L - 1) hi = L - 1;
    if (hi > t_total - 1) hi = t_total - 1;
    const int cnt = hi - t0;
    for (int idx = threadIdx.x; idx < cnt * s_total; idx += blockDim.x) {
      const int r = idx / s_total, c = idx - r * s_total;
      rows[idx] = adv[((size_t)(t0 + r + 1) * batch + b) * s_total + c];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int t = t1 - 1; t >= t0; --t) {
        if (t == L - 1) {
          pos = es;
        } else if (t < L - 1 && t < t_total - 1) {
          const int p = pos < 0 ? 0 : pos;
          pos = p < s_total ? p - rows[(size_t)(t - t0) * s_total + p] : p;
        } else {
          pos = -1;
        }
        out[t - t0] = pos;
      }
    }
    __syncthreads();
    for (int t = t0 + threadIdx.x; t < t1; t += blockDim.x)
      pos_out[(size_t)t * batch + b] = out[t - t0];
    __syncthreads();
  }
}

// The max of the tropical semiring, one FMNMX (fp32).  The max of a set is
// the same value in whatever order the pairs are taken, so the chain's four
// partial maxes give the value the backpointer pass's ascending scan meets.
__device__ __forceinline__ float tmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double tmax(double a, double b) { return fmax(a, b); }

// K10's warp route, the chain: one warp per element b = blockIdx.x walks
// t = 1 .. min(L, T) - 1 and writes d_t into d_out (rows t >= min(L, T)
// are left unwritten: they are -inf, and the pass never reads them).
// Shared memory: the double-buffered row x[2][WN], then, for RN > 1, the
// transition ts[WN * WN], ts[j*WN + i] = T[i, j], -inf padded.  Frame f
// waits in ring slot f % kDepth, loaded kDepth steps before its step (rows
// past frame min(L, T) - 1 are clamped to it and never consumed).
template <typename T, int RN>
__global__ void __launch_bounds__(32, 1) viterbi_fwd_warp_kernel(
    const T* __restrict__ tt_glob,  // (N, N) transposed transition, tt[j*N + i] = T[i, j]
    const T* __restrict__ em,       // (T, B, N) emissions
    const int* __restrict__ li,     // (B,)
    T* __restrict__ d_out,          // (T, B, N) the rows d_t
    T* __restrict__ dend,           // (B, N) end rows
    int t_total, int batch, int n) {
  constexpr int WN = 32 * RN;
  constexpr bool kRegs = RN == 1;  // the transition's column in registers
  constexpr int kGroups = kRegs ? WN / 4 : 4;  // groups of four j unrolled
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xrows = reinterpret_cast<T*>(smem_raw);
  T* ts = xrows + 2 * WN;
  const int b = blockIdx.x, lane = threadIdx.x;
  const int L = li[b];
  const int live = L < 0 ? 0 : (L > t_total ? t_total : L);
  const T ninf = neg_inf<T>();

  T tc[kRegs ? WN : 1];  // tc[j] = T[lane, j]
  if constexpr (kRegs) {
#pragma unroll
    for (int j = 0; j < WN; ++j)
      tc[j] = (j < n && lane < n) ? tt_glob[(size_t)j * n + lane] : ninf;
  } else {
    tc[0] = ninf;
    for (int idx = lane; idx < WN * WN; idx += 32) {
      const int j = idx / WN, i = idx - j * WN;
      ts[idx] = (j < n && i < n) ? tt_glob[(size_t)j * n + i] : ninf;
    }
    __syncwarp();
  }
  T d[RN], d_end[RN];
#pragma unroll
  for (int r = 0; r < RN; ++r) d_end[r] = ninf;
  if (live > 0) {
    T evb[kDepth][RN];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int f = u < live ? u : live - 1;
      load_row(em + ((size_t)f * batch + b) * n, n, lane, evb[u]);
    }
    // d_0 = I_0 (-inf past N)
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      d[r] = evb[0][r];
      if (L == 1) d_end[r] = d[r];
    }
    store_row(d_out + (size_t)b * n, n, lane, d);
    {
      const int f = kDepth < live ? kDepth : live - 1;
      load_row(em + ((size_t)f * batch + b) * n, n, lane, evb[0]);
    }

    for (int t0 = 1; t0 < live; t0 += kDepth) {
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        // step t: frame t sits in slot cur; d_{t-1} goes through buffer u & 1
        const int t = t0 + u;
        if (t >= live) break;
        const int cur = (1 + u) % kDepth;
        T* xr = xrows + (u & 1) * WN;
#pragma unroll
        for (int r = 0; r < RN; ++r) xr[lane + 32 * r] = d[r];
        __syncwarp();

        // best_i = max_j (T[i, j] + d_{t-1}[j]): the row read as broadcasts,
        // four words a load, into four partial maxes (j mod 4)
        T acc[4][RN];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int r = 0; r < RN; ++r) acc[q][r] = ninf;
        }
#pragma unroll kGroups
        for (int j = 0; j < WN; j += 4) {
          T xv[4];
          load4(xr + j, xv);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if constexpr (kRegs) {
              acc[q][0] = tmax(acc[q][0], tc[j + q] + xv[q]);
            } else {
              const T* tj = ts + (j + q) * WN + lane;
#pragma unroll
              for (int r = 0; r < RN; ++r) acc[q][r] = tmax(acc[q][r], tj[32 * r] + xv[q]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RN; ++r)
          d[r] = evb[cur][r] + tmax(tmax(acc[0][r], acc[1][r]), tmax(acc[2][r], acc[3][r]));

        // refill slot cur with frame t + kDepth; the row and the end row, off
        // the chain
        const int f = t + kDepth < live ? t + kDepth : live - 1;
        load_row(em + ((size_t)f * batch + b) * n, n, lane, evb[cur]);
        store_row(d_out + ((size_t)t * batch + b) * n, n, lane, d);
        if (t == L - 1) {
#pragma unroll
          for (int r = 0; r < RN; ++r) d_end[r] = d[r];
        }
      }
    }
  }
  store_row(dend + (size_t)b * n, n, lane, d_end);
}

constexpr int kBpWarps = 4;

// K10's warp route, the backpointers: one block of kBpWarps warps per
// (element b = blockIdx.y, chunk blockIdx.x of ``chunk`` frames), warp w
// taking the chunk's frames t_begin + w, t_begin + w + kBpWarps, ..., lane
// l labels l, l+32, ...  backptr[t][i] = the lowest j reaching max_j
// (T[i, j] + d_{t-1}[j]) (strict > over ascending j), with d_{t-1} the
// chain's row through a shared row read as broadcasts and the candidates
// formed as the chain forms them; the identity at t = 0; 0 where t - 1 >=
// min(L, T), where every candidate is -inf.  Shared memory: one row[WN] a
// warp, then, for RN > 1, the transition ts[WN * WN] as the chain holds it.
template <typename T, int RN>
__global__ void __launch_bounds__(kBpWarps * 32) viterbi_bp_kernel(
    const T* __restrict__ tt_glob,  // (N, N) tt[j*N + i] = T[i, j]
    const T* __restrict__ d,        // (T, B, N) the chain's rows
    const int* __restrict__ li, int* __restrict__ bp, int t_total, int batch, int n,
    int chunk) {
  constexpr int WN = 32 * RN;
  constexpr bool kRegs = RN == 1;
  constexpr int kGroups = kRegs ? WN / 4 : 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* xr = reinterpret_cast<T*>(smem_raw) + warp * WN;
  T* ts = reinterpret_cast<T*>(smem_raw) + kBpWarps * WN;
  const int b = blockIdx.y;
  const int L = li[b];
  const int live = L < 0 ? 0 : (L > t_total ? t_total : L);
  const int t_begin = blockIdx.x * chunk;
  const int t_stop = t_begin + chunk < t_total ? t_begin + chunk : t_total;
  const T ninf = neg_inf<T>();

  T tc[kRegs ? WN : 1];  // tc[j] = T[lane, j]
  if constexpr (kRegs) {
#pragma unroll
    for (int j = 0; j < WN; ++j)
      tc[j] = (j < n && lane < n) ? tt_glob[(size_t)j * n + lane] : ninf;
  } else {
    tc[0] = ninf;
    for (int idx = threadIdx.x; idx < WN * WN; idx += kBpWarps * 32) {
      const int j = idx / WN, i = idx - j * WN;
      ts[idx] = (j < n && i < n) ? tt_glob[(size_t)j * n + i] : ninf;
    }
    __syncthreads();
  }

  for (int t = t_begin + warp; t < t_stop; t += kBpWarps) {
    int arg[RN];
#pragma unroll
    for (int r = 0; r < RN; ++r) arg[r] = t == 0 ? lane + 32 * r : 0;
    if (t >= 1 && t - 1 < live) {  // the same for the whole warp
      T x[RN];
      load_row(d + ((size_t)(t - 1) * batch + b) * n, n, lane, x);
      __syncwarp();  // the previous frame's reads of the row are done
#pragma unroll
      for (int r = 0; r < RN; ++r) xr[lane + 32 * r] = x[r];
      __syncwarp();
      T best[RN];
#pragma unroll
      for (int r = 0; r < RN; ++r) best[r] = ninf;
#pragma unroll kGroups
      for (int j = 0; j < WN; j += 4) {
        T xv[4];
        load4(xr + j, xv);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int r = 0; r < RN; ++r) {
            T c;
            if constexpr (kRegs) {
              c = tc[j + q] + xv[q];
            } else {
              c = ts[(j + q) * WN + lane + 32 * r] + xv[q];
            }
            if (c > best[r]) {
              best[r] = c;
              arg[r] = j + q;
            }
          }
        }
      }
    }
    const size_t row = ((size_t)t * batch + b) * n;
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      if (lane + 32 * r < n) bp[row + lane + 32 * r] = arg[r];
    }
  }
}

// Frames of aligned rows in flight in K12's warp route: 32, or 16 where a
// lane's row is 16 or 32 bytes (fp32 RS = 4, fp64 RS = 2 and 4), so that
// the ring stays at or under 128 registers.
template <typename T, int RS>
__host__ __device__ constexpr int align_ring() { return RS * sizeof(T) <= 8 ? 32 : 16; }

// K12's warp route: one warp per element b = blockIdx.x walks rows t = 1 ..
// live - 1 (live = L clipped to [0, T]) on the chain, then row L (when 1 <=
// L < T) from d_{L-1}; the end row is d_{L-1}.  Frame f of the chain waits
// in ring slot (f - 1) % kRing, loaded kRing steps before its step into
// the slot its step has just read (frames from live on are not loaded).
// A step's addresses are pointer increments: one warp issues every
// instruction in order, so integer work paces the chain as much as its
// arithmetic does.
template <typename T, int RS>
__global__ void __launch_bounds__(32, 1) align_forward_warp_kernel(
    const T* __restrict__ ap,       // (T, B, S) aligned emissions
    const T* __restrict__ self_tr,  // (B, S) stay transitions
    const T* __restrict__ next_tr,  // (B, S) advance transitions, slot s -> s+1
    const int* __restrict__ li,     // (B,)
    int* __restrict__ adv,          // (T, B, S) advance bits
    T* __restrict__ dend,           // (B, S) end rows
    int t_total, int batch, int s_total) {
  constexpr int kRing = align_ring<T, RS>();
  const int b = blockIdx.x, lane = threadIdx.x;
  const int L = li[b];
  const int live = L < 0 ? 0 : (L > t_total ? t_total : L);
  const int last = L >= 1 && L < t_total ? L : live - 1;  // the last row of bits
  const size_t stride = (size_t)batch * s_total;           // one frame's row
  const T ninf = neg_inf<T>();
  bool has[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) has[r] = lane + 32 * r < s_total;

  // row 0 (a dummy) and the rows past the last: zeros, off the chain
  int* bits = adv + (size_t)b * s_total + lane;  // frame 0, lane's word 0
  for (int t = 0; t < t_total; t = t == 0 && last > 0 ? last + 1 : t + 1) {
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      if (has[r]) bits[t * stride + 32 * r] = 0;
    }
  }

  T stay_tr[RS], move_tr[RS], d[RS], d_end[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int k = lane + 32 * r;
    const size_t bs = (size_t)b * s_total + k;
    stay_tr[r] = has[r] ? self_tr[bs] : T(0);
    move_tr[r] = (k >= 1 && has[r]) ? next_tr[bs - 1] : T(0);
    d[r] = k == 0 ? ap[(size_t)b * s_total] : ninf;  // d_0: A_0 at slot 0 only
  }
  // one step from d: the bits of row t, and d_t = a + the chosen edge
  auto step = [&](const T (&a)[RS], int* row) {
    T prev[RS];  // d_{t-1}[s-1], -inf at slot 0
    shift_up_slots<T, RS>(d, 1, lane, prev);
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const T stay = d[r] + stay_tr[r];
      const T move = prev[r] + move_tr[r];  // -inf at slot 0: prev is -inf, move_tr 0
      const bool advanced = move > stay;    // a tie stays
      d[r] = a[r] + (advanced ? move : stay);
      if (has[r]) row[32 * r] = advanced ? 1 : 0;
    }
  };

  if (live > 1) {
    const T* src = ap + (size_t)b * s_total + lane + stride;  // frame 1, lane's word 0
    T ring[kRing][RS];
#pragma unroll
    for (int u = 0; u < kRing; ++u) {
#pragma unroll
      for (int r = 0; r < RS; ++r) ring[u][r] = 1 + u < live && has[r] ? src[32 * r] : ninf;
      src += stride;
    }
    int* row = bits + stride;  // frame 1
    for (int t0 = 1; t0 < live; t0 += kRing) {
#pragma unroll
      for (int u = 0; u < kRing; ++u) {
        const int t = t0 + u;
        if (t >= live) break;
        step(ring[u], row);
        row += stride;
        // frame t + kRing into the slot just read
#pragma unroll
        for (int r = 0; r < RS; ++r)
          ring[u][r] = t + kRing < live && has[r] ? src[32 * r] : ninf;
        src += stride;
      }
    }
  }
  // d_{L-1}, then row L from it (A_L is -inf: only the bits matter)
#pragma unroll
  for (int r = 0; r < RS; ++r) d_end[r] = L >= 1 && L <= t_total ? d[r] : ninf;
  if (L >= 1 && L < t_total) {
    T a[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r) a[r] = ninf;
    step(a, bits + (size_t)L * stride);
  }
  store_row(dend + (size_t)b * s_total, s_total, lane, d_end);
}

// Frames of rows in flight in the backtraces' warp route: 32, or 16 where a
// lane's row is 4 words (RW = 4), so that the ring stays at 64 registers.
template <int RW>
__host__ __device__ constexpr int backtrace_ring() { return RW <= 2 ? 32 : 16; }

// The warp route of K11 (kAlign false: x = the label, rows = backpointers)
// and K13 (kAlign true: x = the position, rows = advance bits): one warp per
// element b = blockIdx.x.  Frame t reads row t + 1, which waits in ring slot
// (live - 2 - t) % kRing, loaded kRing steps before its step into the slot
// its step has just read.  Loads never wait on a condition: the loads for
// the steps past frame 0, which store nothing, read row 1 again.  (Loads
// under a condition made the compiler branch around them at RW > 1, and a
// branch in the group serialised the steps.)  The word is picked by
// comparing s with each word's bound; a test of s >> 5 against the word's
// index made the compiler index a copy of the row in local memory.
template <bool kAlign, int RW>
__device__ __forceinline__ void backtrace_warp(
    const int* __restrict__ rows,   // (T, B, W) backpointers or advance bits
    const int* __restrict__ start,  // (B,) final labels or end slots
    const int* __restrict__ li,     // (B,)
    int* __restrict__ out,          // (T, B) path or positions
    int t_total, int batch, int width) {
  constexpr int kRing = backtrace_ring<RW>();
  const int b = blockIdx.x, lane = threadIdx.x;
  const int L = li[b];
  const int live = L < 0 ? 0 : (L > t_total ? t_total : L);
  // frame live - 1 holds the start where L lies in [1, T], -1 past T
  int x = L >= 1 && L <= t_total ? start[b] : -1;
  // frames live - 1 .. T - 1, off the chain: x, then -1
  for (int t = (live > 0 ? live - 1 : 0) + lane; t < t_total; t += 32)
    out[(size_t)t * batch + b] = t == live - 1 ? x : -1;
  if (live < 2) return;

  bool has[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) has[r] = lane + 32 * r < width;
  const size_t stride = (size_t)batch * width;  // one frame's rows
  const int* src = rows + ((size_t)(live - 1) * batch + b) * width + lane;  // row live - 1
  int ring[kRing][RW];
#pragma unroll
  for (int u = 0; u < kRing; ++u) {  // rows live - 1 - u, row 1 below it
#pragma unroll
    for (int r = 0; r < RW; ++r) ring[u][r] = has[r] ? src[32 * r] : 0;
    src -= live - 2 - u >= 1 ? stride : 0;
  }
  int* dst = out + (size_t)(live - 2) * batch + b;  // frame live - 2
  for (int t0 = live - 2; t0 >= 0; t0 -= kRing) {
#pragma unroll
    for (int u = 0; u < kRing; ++u) {
      const int t = t0 - u;  // reads row t + 1 from slot u
      const int s = x > 0 ? x : 0;
      int w = 0;  // the lane's word s >> 5 of the row, 0 past the last
#pragma unroll
      for (int r = RW - 1; r >= 0; --r) w = s < 32 * (r + 1) ? ring[u][r] : w;
      const int v = __shfl_sync(kFull, w, s & 31);
      x = kAlign ? s - v : v;
      if (lane == 0 && t >= 0) *dst = x;
      dst -= batch;
      // row t + 1 - kRing (row 1 below it) into the slot just read
#pragma unroll
      for (int r = 0; r < RW; ++r) ring[u][r] = has[r] ? src[32 * r] : 0;
      src -= t > kRing ? stride : 0;
    }
  }
}

template <int RW>
__global__ void __launch_bounds__(32, 1) viterbi_backtrace_warp_kernel(
    const int* __restrict__ bp, const int* __restrict__ fin, const int* __restrict__ li,
    int* __restrict__ path, int t_total, int batch, int n) {
  backtrace_warp<false, RW>(bp, fin, li, path, t_total, batch, n);
}

template <int RW>
__global__ void __launch_bounds__(32, 1) align_backtrace_warp_kernel(
    const int* __restrict__ adv, const int* __restrict__ end_s, const int* __restrict__ li,
    int* __restrict__ pos, int t_total, int batch, int s_total) {
  backtrace_warp<true, RW>(adv, end_s, li, pos, t_total, batch, s_total);
}

template <bool kAlign, int RW>
void launch_backtrace_warp_r(const int* rows, const int* start, const int* li, int* out,
                             int t_total, int batch, int width, cudaStream_t st) {
  if constexpr (kAlign) {
    align_backtrace_warp_kernel<RW><<<batch, 32, 0, st>>>(rows, start, li, out, t_total,
                                                          batch, width);
  } else {
    viterbi_backtrace_warp_kernel<RW><<<batch, 32, 0, st>>>(rows, start, li, out, t_total,
                                                            batch, width);
  }
}

// RW = 1, 2 or 4 words a lane of each row: width <= 128.
template <bool kAlign>
int launch_backtrace_warp(const int* rows, const int* start, const int* li, int* out,
                          int t_total, int batch, int width, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (width <= 32) {
    launch_backtrace_warp_r<kAlign, 1>(rows, start, li, out, t_total, batch, width, st);
  } else if (width <= 64) {
    launch_backtrace_warp_r<kAlign, 2>(rows, start, li, out, t_total, batch, width, st);
  } else if (width <= 128) {
    launch_backtrace_warp_r<kAlign, 4>(rows, start, li, out, t_total, batch, width, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_align_forward(const T* ap, const T* self_tr, const T* next_tr, const int* li,
                         int* adv, T* dend, int t_total, int batch, int s_total,
                         void* stream) {
  const int threads = ((s_total + 31) / 32) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  align_forward_kernel<T><<<batch, threads, sizeof(T) * (size_t)s_total,
                            (cudaStream_t)stream>>>(ap, self_tr, next_tr, li, adv, dend,
                                                    t_total, batch, s_total);
  return (int)cudaGetLastError();
}

// RS = 1, 2 or 4 words a lane of each slot row: S <= 128.
template <typename T>
int launch_align_forward_warp(const T* ap, const T* self_tr, const T* next_tr, const int* li,
                              int* adv, T* dend, int t_total, int batch, int s_total,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (s_total <= 32) {
    align_forward_warp_kernel<T, 1><<<batch, 32, 0, st>>>(ap, self_tr, next_tr, li, adv, dend,
                                                          t_total, batch, s_total);
  } else if (s_total <= 64) {
    align_forward_warp_kernel<T, 2><<<batch, 32, 0, st>>>(ap, self_tr, next_tr, li, adv, dend,
                                                          t_total, batch, s_total);
  } else if (s_total <= 128) {
    align_forward_warp_kernel<T, 4><<<batch, 32, 0, st>>>(ap, self_tr, next_tr, li, adv, dend,
                                                          t_total, batch, s_total);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_forward(const T* tt, const T* em, const int* li, int* bp, T* dend,
                   int t_total, int batch, int n, void* stream) {
  const int threads = ((n + 31) / 32) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t base = sizeof(T) * (size_t)n;
  const size_t tt_bytes = sizeof(T) * (size_t)n * n;
  const int tt_in_smem = base + tt_bytes <= kSmemLimit;
  const size_t smem = base + (tt_in_smem ? tt_bytes : 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  viterbi_forward_kernel<T><<<batch, threads, smem, (cudaStream_t)stream>>>(
      tt, em, li, bp, dend, t_total, batch, n, tt_in_smem);
  return (int)cudaGetLastError();
}

template <typename T, int RN>
int launch_forward_warp_r(const T* tt, const T* em, const int* li, int* bp, T* dend,
                          T* d_rows, int t_total, int batch, int n, int chunk,
                          cudaStream_t st) {
  constexpr int WN = 32 * RN;
  const size_t smem = sizeof(T) * (2 * (size_t)WN + (RN == 1 ? 0 : (size_t)WN * WN));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(viterbi_fwd_warp_kernel<T, RN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  viterbi_fwd_warp_kernel<T, RN><<<batch, 32, smem, st>>>(tt, em, li, d_rows, dend,
                                                          t_total, batch, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t bp_smem = sizeof(T) * (kBpWarps * (size_t)WN + (RN == 1 ? 0 : (size_t)WN * WN));
  if (bp_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(viterbi_bp_kernel<T, RN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bp_smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nchunks = (t_total + chunk - 1) / chunk;
  viterbi_bp_kernel<T, RN><<<dim3(nchunks, batch), kBpWarps * 32, bp_smem, st>>>(
      tt, d_rows, li, bp, t_total, batch, n, chunk);
  return (int)cudaGetLastError();
}

// RN = 1, 2 or 4 words a lane of each label row: N <= 128.
template <typename T>
int launch_forward_warp(const T* tt, const T* em, const int* li, int* bp, T* dend,
                        T* d_rows, int t_total, int batch, int n, int chunk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  if (n <= 32)
    return launch_forward_warp_r<T, 1>(tt, em, li, bp, dend, d_rows, t_total, batch, n,
                                       chunk, st);
  if (n <= 64)
    return launch_forward_warp_r<T, 2>(tt, em, li, bp, dend, d_rows, t_total, batch, n,
                                       chunk, st);
  if (n <= 128)
    return launch_forward_warp_r<T, 4>(tt, em, li, bp, dend, d_rows, t_total, batch, n,
                                       chunk, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int viterbi_forward_f32(const float* tt, const float* em, const int* li,
                        int* bp, float* dend, int t_total, int batch, int n,
                        void* stream) {
  return launch_forward<float>(tt, em, li, bp, dend, t_total, batch, n, stream);
}

int viterbi_forward_f64(const double* tt, const double* em, const int* li,
                        int* bp, double* dend, int t_total, int batch, int n,
                        void* stream) {
  return launch_forward<double>(tt, em, li, bp, dend, t_total, batch, n, stream);
}

int viterbi_backtrace(const int* bp, const int* fin, const int* li, int* path,
                      int t_total, int batch, int n, void* stream) {
  int tc = 8192 / (n > 0 ? n : 1);
  if (tc > 256) tc = 256;
  if (tc < 1) tc = 1;
  const size_t smem = sizeof(int) * ((size_t)tc * n + tc);
  viterbi_backtrace_kernel<<<batch, 128, smem, (cudaStream_t)stream>>>(
      bp, fin, li, path, t_total, batch, n, tc);
  return (int)cudaGetLastError();
}

// K11's warp route: the block route's arguments.
int viterbi_backtrace_warp(const int* bp, const int* fin, const int* li, int* path,
                           int t_total, int batch, int n, void* stream) {
  return launch_backtrace_warp<false>(bp, fin, li, path, t_total, batch, n, stream);
}

int align_forward_f32(const float* ap, const float* self_tr, const float* next_tr,
                      const int* li, int* adv, float* dend, int t_total, int batch,
                      int s_total, void* stream) {
  return launch_align_forward<float>(ap, self_tr, next_tr, li, adv, dend, t_total, batch,
                                     s_total, stream);
}

int align_forward_f64(const double* ap, const double* self_tr, const double* next_tr,
                      const int* li, int* adv, double* dend, int t_total, int batch,
                      int s_total, void* stream) {
  return launch_align_forward<double>(ap, self_tr, next_tr, li, adv, dend, t_total, batch,
                                      s_total, stream);
}

// K12's warp route: the block route's arguments.

int align_forward_warp_f32(const float* ap, const float* self_tr, const float* next_tr,
                           const int* li, int* adv, float* dend, int t_total, int batch,
                           int s_total, void* stream) {
  return launch_align_forward_warp<float>(ap, self_tr, next_tr, li, adv, dend, t_total, batch,
                                          s_total, stream);
}

int align_forward_warp_f64(const double* ap, const double* self_tr, const double* next_tr,
                           const int* li, int* adv, double* dend, int t_total, int batch,
                           int s_total, void* stream) {
  return launch_align_forward_warp<double>(ap, self_tr, next_tr, li, adv, dend, t_total,
                                           batch, s_total, stream);
}

int align_backtrace(const int* adv, const int* end_s, const int* li, int* pos,
                    int t_total, int batch, int s_total, void* stream) {
  int tc = 8192 / (s_total > 0 ? s_total : 1);
  if (tc > 256) tc = 256;
  if (tc < 1) tc = 1;
  const size_t smem = sizeof(int) * ((size_t)tc * s_total + tc);
  align_backtrace_kernel<<<batch, 128, smem, (cudaStream_t)stream>>>(
      adv, end_s, li, pos, t_total, batch, s_total, tc);
  return (int)cudaGetLastError();
}

// K13's warp route: the block route's arguments.
int align_backtrace_warp(const int* adv, const int* end_s, const int* li, int* pos,
                         int t_total, int batch, int s_total, void* stream) {
  return launch_backtrace_warp<true>(adv, end_s, li, pos, t_total, batch, s_total, stream);
}

// K10's warp route: the block route's arguments, then a (T, B, N) scratch
// of the chain's rows, the sizes and the frames per chunk of the
// backpointer pass.

int viterbi_forward_warp_f32(const float* tt, const float* em, const int* li, int* bp,
                             float* dend, float* d_rows, int t_total, int batch, int n,
                             int chunk, void* stream) {
  return launch_forward_warp<float>(tt, em, li, bp, dend, d_rows, t_total, batch, n, chunk,
                                    stream);
}

int viterbi_forward_warp_f64(const double* tt, const double* em, const int* li, int* bp,
                             double* dend, double* d_rows, int t_total, int batch, int n,
                             int chunk, void* stream) {
  return launch_forward_warp<double>(tt, em, li, bp, dend, d_rows, t_total, batch, n, chunk,
                                     stream);
}

}  // extern "C"
