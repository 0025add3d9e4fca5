// The encoder's stride-1 "SAME" convolutions on channels-last float32
// activations, as implicit GEMMs on the SIMT cores: forward with the bias
// and ReLU fused, input gradient (dgrad) and weight gradient (wgrad).
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// It takes the place of cuDNN's NCL kernels for the encoders' blocks of
// stride 1 and width K, odd or even, with SAME pads (left = (K - 1) / 2,
// right = K / 2 frames), which do the most of a training step's device work.
//
// Activations are (B, T, C) row-major.  Row (b, t) of the unfolded input is
// the K * C floats x[b, t - pad .. t - pad + K - 1, :], pad the left pad,
// which lie contiguous in memory: element kk of it is
// x[b * T * C + (t - pad) * C + kk], zero where (t - pad) * C + kk falls
// outside [0, T * C) (the SAME padding, by predicate; no padded copy
// exists).  So
//   forward: out[m, n] = relu?(bias[n] + sum_kk A(m, kk) W[kk, n]),
//            W[k * Cin + c, n] = weight[n, c, k], the ReLU by a flag;
//   dgrad:   dx = the same product on the masked gradient g (B, T, Cout)
//            with W[k * Cout + n, c] = weight[n, c, K - 1 - k], no bias or
//            ReLU, and pad the right pad (the transposed convolution swaps
//            the pads);
//   wgrad:   dW[n, kk] = sum_m g[m, n] A(m, kk), split over m into slices
//            whose partial products a second kernel sums in slice order.
// The wrapper (conv_kernels.py) lays out W, zero-padded to whole tiles.
//
// What bounds it on an H100: float32 operations, 2 B T Cout K Cin a pass
// (56 GFLOP for a 250 -> 250 layer at B = 64, T = 1000) against 67 TFLOP/s
// of FMAs; every operand is read a few times from L2 at most.  So the
// measure is the share of issue slots that are FMAs and how many of them
// stall.  The first design (128 x 128 tiles, 8 x 8 accumulators a thread,
// two blocks an SM at 127 registers) ran 40-45 TFLOP/s with 86% of its
// loop's instructions FMAs (PERF.md, diagnosis): four float4 shared loads
// for 64 FMAs a thread, 16 warps an SM, filled the shared-memory pipe as
// fast as the FMAs filled theirs, and the clock stayed within 1% of its
// maximum.  Timed with parts of the loop taken out, this design's FMAs
// alone reach 52-57 TFLOP/s, with the shared loads 48-51, and the gather's
// copies take the rest.
//
// The design: a thread holds 16 x 8 accumulators (four 4-row strips by two
// 4-column strips, so a warp's fragment loads are four float4 rows
// broadcast to 8 lanes each and eight contiguous float4 columns: no bank
// conflicts), 24 floats of fragments for 128 FMAs, and loads depth k + 1's
// fragments while depth k's FMAs issue (two register sets).  Warps are
// 64 x 64, 4 x 8 lanes.  The operands stream through a 4-deep ring of
// depth-8 stages filled by cp.async, a stage's copies issued together.
// Each gathered row keeps a pointer and its offset in its utterance, so a
// 4-byte copy costs one compare; the wgrad copies a row 16 bytes at a time
// where its width is a multiple of 4 floats (Cout for g, Cin for x).  Two
// tilings share that loop (`Tiling`): 128 x 256 with 256 threads and one
// block an SM, the faster where both fit a product alike (fewer copies a
// FMA), and 128 x 128 with 128 threads and two blocks an SM, which pads
// less of a product whose columns are not whole 256s; each at up to 255
// registers.  The wrapper picks the one whose padded tiles take the fewest
// waves of the card (conv_kernels.py::pick_tiling).  A 256 x 128 tiling of
// 256 threads was 3-10% slower in every forward timed: one block's 8 warps
// wait on their own copies at each stage's barrier.  Each accumulator sums its
// products in ascending reduction order in float32 FMAs, then the bias,
// then the ReLU; no tensor cores, no atomics: two runs give the same bits,
// and the forward and dgrad give the first design's.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDepth = 8;      // reduction depth of a stage
constexpr int kStages = 4;     // stages in flight
constexpr int kTM = 16;        // accumulator rows a thread
constexpr int kTN = 8;         // accumulator columns a thread

// A tiling of the product: kRows x kCols a block in warps of 64 x 64,
// kThreads threads of 16 x 8 accumulators, kMinBlocks resident blocks an SM
// at up to 255 registers a thread.
template <int Rows, int Cols>
struct Tiling {
  static constexpr int kRows = Rows;
  static constexpr int kCols = Cols;
  static constexpr int kThreads = Rows * Cols / (kTM * kTN);
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kWarpsN = Cols / 64;  // warps across the columns
  static constexpr int kMinBlocks = 65536 / (kThreads * 255) >= 2 ? 2 : 1;
  // a[k][i] rows: the gather's transposed 4-byte stores of 4 depths x 8
  // rows a warp hit 32 banks (pitch = 8 mod 32)
  static constexpr int kPitchA = Rows + 8;
  static constexpr int kSlotA = kDepth * kPitchA;
  static constexpr int kSlot = kSlotA + kDepth * Cols;  // floats of one stage
  static constexpr int kSmemBytes = kStages * kSlot * 4;
  static_assert(Rows % 64 == 0 && Cols % 64 == 0, "warps of 64 x 64");
};

// The two tilings, in the order conv_tiling lists them.
using TilingA = Tiling<128, 256>;
using TilingB = Tiling<128, 128>;

// Stage slot s of the ring: a[k][i] = row i of the tile at depth k (pitch
// kPitchA), then b[k][j] = column j at depth k (pitch kCols).
template <class T>
__device__ __forceinline__ float* slot_a(float* smem, int s) { return smem + s * T::kSlot; }
template <class T>
__device__ __forceinline__ float* slot_b(float* smem, int s) {
  return smem + s * T::kSlot + T::kSlotA;
}

// A float, or a zero where !valid: then nothing is read, and src may lie
// outside the tensor.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 4 : 0));
}

// Four floats from a 16-byte aligned source, or zeros where !valid.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The thread's first accumulator row and column in the block tile: its rows
// are row0 + 16 s + e (s < 4, e < 4), its columns col0 + 32 s + e (s < 2).
// A warp's lanes are 4 rows by 8 columns of 4 x 4 blocks.
template <class T>
__device__ __forceinline__ int frag_row0() {
  return (threadIdx.x / 32 / T::kWarpsN) * 64 + (threadIdx.x % 32 / 8) * 4;
}
template <class T>
__device__ __forceinline__ int frag_col0() {
  return (threadIdx.x / 32 % T::kWarpsN) * 64 + (threadIdx.x % 8) * 4;
}
template <class T>
__device__ __forceinline__ int acc_row(int i) { return frag_row0<T>() + (i / 4) * 16 + i % 4; }
template <class T>
__device__ __forceinline__ int acc_col(int j) { return frag_col0<T>() + (j / 4) * 32 + j % 4; }

// The fragments of depth k: 16 rows of a[k], 8 columns of b[k].
template <class T>
__device__ __forceinline__ void load_frags(const float* a, const float* b, int k,
                                           float (&af)[kTM], float (&bf)[kTN]) {
  const float* ap = a + k * T::kPitchA + frag_row0<T>();
  const float* bp = b + k * T::kCols + frag_col0<T>();
#pragma unroll
  for (int s = 0; s < kTM / 4; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(ap + 16 * s);
    af[4 * s] = v.x, af[4 * s + 1] = v.y, af[4 * s + 2] = v.z, af[4 * s + 3] = v.w;
  }
#pragma unroll
  for (int s = 0; s < kTN / 4; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(bp + 32 * s);
    bf[4 * s] = v.x, bf[4 * s + 1] = v.y, bf[4 * s + 2] = v.z, bf[4 * s + 3] = v.w;
  }
}

// The ring: stage kt of `stages` is copied in by load(smem, slot), which
// also moves the loader on by a stage, kStages - 1 stages ahead of the one
// multiplied; depth k + 1's fragments are read while depth k's FMAs issue,
// across the stage boundary too.
template <class T, class Load>
__device__ __forceinline__ void mainloop(float* smem, Load& load, int stages,
                                         float (&acc)[kTM][kTN]) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) load(smem, s);
    commit();
  }
  wait_groups<kStages - 2>();
  __syncthreads();  // stage 0 has landed
  float af[2][kTM], bf[2][kTN];
  load_frags<T>(slot_a<T>(smem, 0), slot_b<T>(smem, 0), 0, af[0], bf[0]);
  for (int kt = 0; kt < stages; ++kt) {
    const int slot = kt % kStages;
    const float* a = slot_a<T>(smem, slot);
    const float* b = slot_b<T>(smem, slot);
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      if (k == 0) {
        // into the slot of stage kt - 1, which every thread finished
        // reading before the last barrier
        const int next = kt + kStages - 1;
        if (next < stages) load(smem, next % kStages);
        commit();
      }
      if (k == kDepth - 1) {
        wait_groups<kStages - 2>();
        __syncthreads();  // stage kt + 1 has landed
        const int ns = (kt + 1) % kStages;
        load_frags<T>(slot_a<T>(smem, ns), slot_b<T>(smem, ns), 0, af[(k + 1) % 2],
                      bf[(k + 1) % 2]);
      } else {
        load_frags<T>(a, b, k + 1, af[(k + 1) % 2], bf[(k + 1) % 2]);
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(af[k % 2][i], bf[k % 2][j], acc[i][j]);
    }
  }
  wait_groups<0>();
}

// Forward and dgrad operands: A(m, kk) gathered from x (transposed into
// a[k][i]; lane l copies depths l % 4 and l % 4 + 4 of row l / 4 of its
// warp's 8, so 4 depths x 8 rows of a warp fill 32 banks), W from the
// padded panel (npad columns, whole stages of rows), 16 bytes a copy.
// Each of the thread's rows keeps a pointer to its next element and that
// element's offset in its utterance, c = (t - pad) C + kk, which is in
// range while c < hi = min(T C, (t - pad) C + K C): one compare a copy.
template <class T>
struct UnfoldLoad {
  static constexpr int kRowsA = T::kRows * 4 / T::kThreads;             // rows of A a thread copies
  static constexpr int kCopiesB = kDepth * T::kCols / 4 / T::kThreads;  // float4s of W a thread copies
  static constexpr int kPanelRows = T::kThreads * 4 / T::kCols;  // panel rows of one round of copies
  static_assert(kDepth == 8, "a lane copies depths d and d + 4");
  const float* w;            // this thread's first float4 of the panel at the stage's depth 0
  int npad;
  const float* px[kRowsA];   // the thread's rows' elements at the stage's depth
  unsigned c[kRowsA];        // their offsets in the utterance, (t - pad) C + kk
  unsigned hi[kRowsA];       // the end of the range; 0 past M

  __device__ __forceinline__ void operator()(float* smem, int slot) {
    const int lane = threadIdx.x % 32;
    float* a = slot_a<T>(smem, slot) + (lane % 4) * T::kPitchA + (threadIdx.x / 32) * 8 + lane / 4;
#pragma unroll
    for (int r = 0; r < kRowsA; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        copy4(a + 4 * h * T::kPitchA + r * (T::kThreads / 4), px[r] + 4 * h,
              c[r] + 4 * h < hi[r]);
      px[r] += kDepth;
      c[r] += kDepth;
    }
    float* b = slot_b<T>(smem, slot) + (threadIdx.x * 4 / T::kCols) * T::kCols +
               (threadIdx.x * 4) % T::kCols;
#pragma unroll
    for (int q = 0; q < kCopiesB; ++q)
      copy16(b + q * kPanelRows * T::kCols, w + q * kPanelRows * npad);
    w += kDepth * npad;
  }
};

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
conv_unfold_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int m_total, int n,
                   int npad, int t_len, int c_in, int kd, int kpad, int pad, int relu) {
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * T::kCols, m0 = blockIdx.y * T::kRows;
  const int lane = threadIdx.x % 32;
  const int tc = t_len * c_in;
  UnfoldLoad<T> load;
  load.npad = npad;
  load.w = w + (threadIdx.x * 4 / T::kCols) * npad + n0 + (threadIdx.x * 4) % T::kCols;
#pragma unroll
  for (int r = 0; r < UnfoldLoad<T>::kRowsA; ++r) {
    const int m = m0 + (threadIdx.x / 32) * 8 + lane / 4 + r * (T::kThreads / 4);
    const int lin = (m % t_len - pad) * c_in;  // the row's first element in its utterance
    load.px[r] = x + (static_cast<long long>(m - pad) * c_in + lane % 4);
    load.c[r] = static_cast<unsigned>(lin + lane % 4);
    load.hi[r] = m < m_total ? static_cast<unsigned>(min(tc, lin + kd)) : 0u;
  }
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  mainloop<T>(smem, load, kpad / kDepth, acc);

  float bv[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int col = n0 + acc_col<T>(j);
    bv[j] = bias != nullptr && col < n ? bias[col] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + acc_row<T>(i);
    if (row >= m_total) continue;
    float* o = out + static_cast<long long>(row) * n;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + acc_col<T>(j);
      if (col < n) {
        float v = acc[i][j] + bv[j];
        if (relu) v = v < 0.f ? 0.f : v;  // NaN passes, as torch.relu's
        o[col] = v;
      }
    }
  }
}

// Wgrad operands over a slice of m: g rows (a[k][i] = g[m, n0 + i]) and
// unfolded x rows (b[k][j] = A(m, kk0 + j)), both copied as they lie.  Warp
// w copies row w + kWarps p of each stage; lane l copies columns l + 32 q
// (4 bytes a copy), or float4s l + 32 q where vec_g (vec_x) says g's (x's)
// rows are whole float4s.  Each row keeps pointers to its elements, the
// rows left in the slice, its frame and u = (t - pad) Cin + kk0 + the
// lane's first column, which the SAME padding's range is checked on; a
// stage moves them on by kDepth rows, with no division.
template <class T>
struct WgradLoad {
  static constexpr int kPasses = kDepth / T::kWarps;  // rows of a stage a thread copies
  const float* gp[kPasses];  // g[m, n0 + lane (x 4 where vec_g)]
  const float* xp[kPasses];  // A(m, kk0 + lane (x 4 where vec_x))
  int left[kPasses];         // rows of the slice from m on; the row is in it while > 0
  int t[kPasses];            // m's frame
  int u[kPasses];            // (t - pad) Cin + the first column's kk
  int t_len, tc, gstep, xstep;  // kDepth n_out and kDepth Cin
  int nl, kl;                // columns of g and of the unfolded x from the lane's first on
  bool vec_g, vec_x;

  __device__ __forceinline__ void operator()(float* smem, int slot) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int row = threadIdx.x / 32 + T::kWarps * p;
      const bool in = left[p] > 0;
      if (vec_g) {
        float* a = slot_a<T>(smem, slot) + row * T::kPitchA + 4 * lane;
#pragma unroll
        for (int q = 0; q < T::kRows / 128; ++q)
          copy16(a + 128 * q, gp[p] + 128 * q, in && 128 * q < nl);
      } else {
        float* a = slot_a<T>(smem, slot) + row * T::kPitchA + lane;
#pragma unroll
        for (int q = 0; q < T::kRows / 32; ++q)
          copy4(a + 32 * q, gp[p] + 32 * q, in && 32 * q < nl);
      }
      if (vec_x) {
        float* b = slot_b<T>(smem, slot) + row * T::kCols + 4 * lane;
#pragma unroll
        for (int q = 0; q < T::kCols / 128; ++q)
          copy16(b + 128 * q, xp[p] + 128 * q,
                 in && 128 * q < kl &&
                     static_cast<unsigned>(u[p] + 128 * q) < static_cast<unsigned>(tc));
      } else {
        float* b = slot_b<T>(smem, slot) + row * T::kCols + lane;
#pragma unroll
        for (int q = 0; q < T::kCols / 32; ++q)
          copy4(b + 32 * q, xp[p] + 32 * q,
                in && 32 * q < kl &&
                    static_cast<unsigned>(u[p] + 32 * q) < static_cast<unsigned>(tc));
      }
      gp[p] += gstep;
      xp[p] += xstep;
      left[p] -= kDepth;
      t[p] += kDepth;
      u[p] += xstep;
      while (t[p] >= t_len) {  // into the next utterance
        t[p] -= t_len;
        u[p] -= tc;
      }
    }
  }
};

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
conv_wgrad_kernel(const float* __restrict__ g, const float* __restrict__ x,
                  float* __restrict__ part, int m_total, int n_out, int t_len, int c_in, int kd,
                  int pad, int chunk, int vec_g, int vec_x) {
  extern __shared__ __align__(16) float smem[];
  const int kk0 = blockIdx.x * T::kCols, n0 = blockIdx.y * T::kRows, s = blockIdx.z;
  const int m_begin = s * chunk, m_end = min(m_total, m_begin + chunk);
  const int lane = threadIdx.x % 32;
  const int gcol = vec_g ? 4 * lane : lane, xcol = vec_x ? 4 * lane : lane;
  WgradLoad<T> load;
  load.t_len = t_len;
  load.tc = t_len * c_in;
  load.gstep = kDepth * n_out;
  load.xstep = kDepth * c_in;
  load.nl = n_out - n0 - gcol;
  load.kl = kd - kk0 - xcol;
  load.vec_g = vec_g != 0;
  load.vec_x = vec_x != 0;
#pragma unroll
  for (int p = 0; p < WgradLoad<T>::kPasses; ++p) {
    const int m = m_begin + threadIdx.x / 32 + T::kWarps * p;
    load.gp[p] = g + (static_cast<long long>(m) * n_out + n0 + gcol);
    load.xp[p] = x + (static_cast<long long>(m - pad) * c_in + kk0 + xcol);
    load.left[p] = m_end - m;
    load.t[p] = m % t_len;
    load.u[p] = (load.t[p] - pad) * c_in + kk0 + xcol;
  }
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  const int rows = m_end - m_begin;
  mainloop<T>(smem, load, rows > 0 ? (rows + kDepth - 1) / kDepth : 0, acc);

  float* p = part + static_cast<long long>(s) * n_out * kd;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int nn = n0 + acc_row<T>(i);
    if (nn >= n_out) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int kk = kk0 + acc_col<T>(j);
      if (kk < kd) p[static_cast<long long>(nn) * kd + kk] = acc[i][j];
    }
  }
}

// dw[n, c, k] = sum over slices s, in order, of part[s, n, k * Cin + c].
__global__ void conv_wgrad_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                      int splits, int n_out, int c_in, int k_w) {
  const int kd = c_in * k_w;
  const long long size = static_cast<long long>(n_out) * kd;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= size) return;
  const int nn = static_cast<int>(i / kd), kk = static_cast<int>(i - static_cast<long long>(nn) * kd);
  const int k = kk / c_in, c = kk - k * c_in;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += part[s * size + i];
  dw[(static_cast<long long>(nn) * c_in + c) * k_w + k] = sum;
}

template <class T>
int launch_fwd(const float* x, const float* w, const float* bias, float* out, int m_total, int n,
               int npad, int t_len, int c_in, int kd, int kpad, int pad, int relu,
               cudaStream_t stream) {
  const cudaError_t set = cudaFuncSetAttribute(
      conv_unfold_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(npad / T::kCols, (m_total + T::kRows - 1) / T::kRows);
  conv_unfold_kernel<T><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      x, w, bias, out, m_total, n, npad, t_len, c_in, kd, kpad, pad, relu);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_wgrad(const float* g, const float* x, float* part, int m_total, int n_out, int t_len,
                 int c_in, int kd, int pad, int splits, int chunk, cudaStream_t stream) {
  const cudaError_t set = cudaFuncSetAttribute(
      conv_wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  // whole float4 rows, 16-byte aligned: a choice by the widths alone for
  // the tensors the wrapper allocates
  const int vec_g = n_out % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const int vec_x = c_in % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((kd + T::kCols - 1) / T::kCols, (n_out + T::kRows - 1) / T::kRows, splits);
  conv_wgrad_kernel<T><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      g, x, part, m_total, n_out, t_len, c_in, kd, pad, chunk, vec_g, vec_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The kernels' shared memory is dynamic, allowed above 48 KB on the current
// device before each launch.
extern "C" {

// The tilings, in the order the entry points' `tiling` argument names
// them: out[0] = their count, then for each {rows and columns of a block's
// tile, reduction depth of a stage, resident blocks an SM}.
void conv_tiling(int* out) {
  const int tilings[2][4] = {{TilingA::kRows, TilingA::kCols, kDepth, TilingA::kMinBlocks},
                             {TilingB::kRows, TilingB::kCols, kDepth, TilingB::kMinBlocks}};
  out[0] = 2;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j) out[1 + 4 * i + j] = tilings[i][j];
}

// x: (B, T, Cin) as m_total = B T rows; w: (kpad, npad) panel; bias: (n,) or
// null; out: (B, T, n).  kd = K Cin; kpad a multiple of the depth, npad of
// the tiling's columns; tiling: 0 or 1, as conv_tiling lists them.
int conv_fwd_f32(const float* x, const float* w, const float* bias, float* out, int m_total,
                 int n, int npad, int t_len, int c_in, int kd, int kpad, int pad, int relu,
                 int tiling, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tiling == 0
             ? launch_fwd<TilingA>(x, w, bias, out, m_total, n, npad, t_len, c_in, kd, kpad,
                                   pad, relu, st)
             : launch_fwd<TilingB>(x, w, bias, out, m_total, n, npad, t_len, c_in, kd, kpad,
                                   pad, relu, st);
}

// g: (B, T, n_out); x: (B, T, Cin); part: (splits, n_out, k_w Cin) scratch;
// dw: (n_out, Cin, k_w).  Slice s holds rows [s chunk, (s + 1) chunk), chunk
// a multiple of the depth.
int conv_wgrad_f32(const float* g, const float* x, float* part, float* dw, int m_total,
                   int n_out, int t_len, int c_in, int k_w, int pad, int splits, int chunk,
                   int tiling, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kd = k_w * c_in;
  const int err = tiling == 0 ? launch_wgrad<TilingA>(g, x, part, m_total, n_out, t_len, c_in,
                                                      kd, pad, splits, chunk, st)
                              : launch_wgrad<TilingB>(g, x, part, m_total, n_out, t_len, c_in,
                                                      kd, pad, splits, chunk, st);
  if (err != 0) return err;
  const long long size = static_cast<long long>(n_out) * kd;
  conv_wgrad_sum_kernel<<<static_cast<unsigned>((size + 255) / 256), 256, 0, st>>>(
      part, dw, splits, n_out, c_in, k_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
