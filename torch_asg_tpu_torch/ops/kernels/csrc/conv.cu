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
// of FMAs; every operand is read a few times from L2 at most.  The design
// is the classic SIMT GEMM: a block of 256 threads owns a 128 x 128 tile of
// the product, each thread an 8 x 8 sub-tile of accumulators (two 4-wide
// strips in each direction, so its shared-memory reads are float4 and free
// of bank conflicts), over reduction stages of 16 held in a 4-deep ring of
// shared memory (66 KB a block, two blocks an SM) filled by cp.async
// (4-byte copies with zero fill for the gathered operands, whose rows have
// any alignment; 16-byte copies for the padded weight panel).  Of the
// tilings timed on the card (depth 8, 16 or 32; 2-4 stages; one or two
// blocks an SM; operands read one depth ahead across the stage boundary or
// not) none was faster on any pass by more than 2% (PERF.md).  Each
// accumulator sums its products in reduction order in float32 FMAs; no
// tensor cores, no atomics: two runs give the same bits.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;            // rows and columns of a block's tile
constexpr int kThreads = 256;
constexpr int kPitch = kTile + 4;     // floats a shared row: transposed stores
                                      // of 8 depths x 4 rows hit 32 banks
constexpr int kRows = kTile * 8 / kThreads;  // gathered tile rows a thread copies: 4
constexpr int kDepth = 16;            // reduction depth of a stage
constexpr int kStages = 4;            // stages in flight
constexpr int kMinBlocks = 2;         // resident blocks an SM the GEMM kernels are built for
constexpr int kSlot = 2 * kDepth * kPitch;              // floats of one stage
constexpr int kSmemBytes = kStages * kSlot * 4;
static_assert(kDepth % 8 == 0, "stages are whole multiples of 8 deep");

// Stage slot s of the ring: a[k][i] = row i of the tile at depth k, then
// b[k][j] = column j at depth k.
__device__ __forceinline__ float* slot_a(float* smem, int s) { return smem + s * kSlot; }
__device__ __forceinline__ float* slot_b(float* smem, int s) {
  return smem + s * kSlot + kDepth * kPitch;
}

// A float, or a zero where !valid: then nothing is read, and src may lie
// outside the tensor.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row i of the thread's 8 x 8 sub-tile within the block tile (columns alike).
__device__ __forceinline__ int sub(int lane16, int i) {
  return (i < 4 ? 0 : kTile / 2) + lane16 * 4 + (i & 3);
}

// acc += the products of one stage.
__device__ __forceinline__ void multiply_stage(const float* a, const float* b,
                                               float (&acc)[8][8]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * kPitch + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * kPitch + kTile / 2 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * kPitch + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(b + k * kPitch + kTile / 2 + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The ring: stage kt of `stages` is loaded by load(smem, slot, kt)
// kStages - 1 stages ahead of the one multiplied.
template <class Load>
__device__ __forceinline__ void mainloop(float* smem, Load& load, int stages,
                                         float (&acc)[8][8]) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) load(smem, s, s);
    commit();
  }
  for (int kt = 0; kt < stages; ++kt) {
    wait_groups<kStages - 2>();
    __syncthreads();  // stage kt has landed, and every thread is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < stages) load(smem, next % kStages, next);
    commit();
    const int slot = kt % kStages;
    multiply_stage(slot_a(smem, slot), slot_b(smem, slot), acc);
  }
  wait_groups<0>();
}

// Forward and dgrad operands: A(m, kk) gathered from x (transposed into
// a[k][i]; lane l copies depth l % 8 of row l / 8, so 8 depths x 4 rows
// of a warp fill 32 banks), W from the padded panel (npad columns, whole
// stages of rows).  Stages are loaded in order: the panel pointer advances
// a stage a call.
struct UnfoldLoad {
  const float* x;
  const float* w;        // this thread's float4 of the panel at the stage's depth 0
  int tc, kd, npad8;     // npad8: 8 rows of the panel
  int lin[kRows];        // (t - pad) * C of the thread's rows; INT_MIN / 2 past M
  int off[kRows];        // b * T * C + (t - pad) * C: where the row's element 0 lies

  __device__ __forceinline__ void operator()(float* smem, int slot, int kt) {
    const int kcol = threadIdx.x % 8;
    float* a = slot_a(smem, slot) + kcol * kPitch + threadIdx.x / 8;
    float* b = slot_b(smem, slot) + (threadIdx.x / 32) * kPitch + (threadIdx.x % 32) * 4;
#pragma unroll
    for (int d = 0; d < kDepth; d += 8) {
      const int kk = kt * kDepth + d + kcol;
      const bool in_k = kk < kd;
      const float* xk = x + kk;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        copy4(a + d * kPitch + r * (kThreads / 8), xk + off[r],
              in_k && static_cast<unsigned>(lin[r] + kk) < static_cast<unsigned>(tc));
      copy16(b + d * kPitch, w + (d / 8) * npad8);
    }
    w += (kDepth / 8) * npad8;
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
conv_unfold_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int m_total, int n,
                   int npad, int t_len, int c_in, int kd, int kpad, int pad, int relu) {
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  UnfoldLoad load;
  load.x = x;
  load.tc = t_len * c_in;
  load.kd = kd;
  load.npad8 = 8 * npad;
  load.w = w + (threadIdx.x / 32) * npad + n0 + (threadIdx.x % 32) * 4;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int m = m0 + threadIdx.x / 8 + r * (kThreads / 8);
    const int b = m / t_len, t = m - b * t_len;
    load.lin[r] = m < m_total ? (t - pad) * c_in : INT_MIN / 2;
    load.off[r] = m < m_total ? b * load.tc + (t - pad) * c_in : 0;
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  mainloop(smem, load, kpad / kDepth, acc);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + sub(tx, j);
    bv[j] = bias != nullptr && col < n ? bias[col] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + sub(ty, i);
    if (row >= m_total) continue;
    float* o = out + static_cast<long long>(row) * n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + sub(tx, j);
      if (col < n) {
        float v = acc[i][j] + bv[j];
        if (relu) v = v < 0.f ? 0.f : v;  // NaN passes, as torch.relu's
        o[col] = v;
      }
    }
  }
}

// Wgrad operands over a slice of m: g rows (a[k][i] = g[m, n0 + i]) and
// unfolded x rows (b[k][j] = A(m, kk0 + j)), both copied as they lie.
// Lane l of warp w copies columns l + 32 q of rows w + 8 r of each stage;
// the row state advances by one stage a call (stages are loaded in order),
// so no division is made in the loop.
struct WgradLoad {
  static constexpr int kGroups = kDepth / 8;  // rows of a stage a thread copies
  static constexpr int kCols = kTile / 32;      // columns of a row a thread copies
  const float* g;
  const float* x;
  int t_len, tc, m_end, step, gstep;  // step: Depth * Cin; gstep: Depth * n_out
  int kkb;                  // kk0 + lane: the thread's first column of the unfolded rows
  bool n_ok[kCols];         // its columns of g lie below n_out
  bool kk_ok[kCols];        // its unfolded columns lie below K Cin
  int m[kGroups];           // the stage's row m of each of the thread's rows
  int t[kGroups];           // its frame
  int lrow[kGroups];        // (t - pad) * Cin
  int xoff[kGroups];        // b * T * Cin + (t - pad) * Cin
  int goff[kGroups];        // m * n_out + n0 + lane

  __device__ __forceinline__ void init(int m_begin, int n_out, int n0, int kk0, int kd, int c_in,
                                       int pad) {
    const int lane = threadIdx.x % 32;
    step = kDepth * c_in;
    gstep = kDepth * n_out;
    kkb = kk0 + lane;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      kk_ok[q] = kkb + 32 * q < kd;
      n_ok[q] = n0 + lane + 32 * q < n_out;
    }
#pragma unroll
    for (int r = 0; r < kGroups; ++r) {
      m[r] = m_begin + 8 * r + threadIdx.x / 32;
      const int b = m[r] / t_len;
      t[r] = m[r] - b * t_len;
      lrow[r] = (t[r] - pad) * c_in;
      xoff[r] = b * tc + lrow[r];
      goff[r] = m[r] * n_out + n0 + lane;
    }
  }

  __device__ __forceinline__ void operator()(float* smem, int slot, int) {
    float* a = slot_a(smem, slot) + threadIdx.x % 32;
    float* bt = slot_b(smem, slot) + threadIdx.x % 32;
#pragma unroll
    for (int r = 0; r < kGroups; ++r) {
      const int k = 8 * r + threadIdx.x / 32;
      const bool in_slice = m[r] < m_end;
      const float* gp = g + goff[r];
      const float* xp = x + (xoff[r] + kkb);
      const int l = lrow[r] + kkb;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        copy4(a + k * kPitch + 32 * q, gp + 32 * q, in_slice && n_ok[q]);
        copy4(bt + k * kPitch + 32 * q, xp + 32 * q,
              in_slice && kk_ok[q] &&
                  static_cast<unsigned>(l + 32 * q) < static_cast<unsigned>(tc));
      }
      m[r] += kDepth;
      goff[r] += gstep;
      t[r] += kDepth;
      lrow[r] += step;
      xoff[r] += step;
      while (t[r] >= t_len) {  // into the next utterance
        t[r] -= t_len;
        lrow[r] -= tc;
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
conv_wgrad_kernel(const float* __restrict__ g, const float* __restrict__ x,
                  float* __restrict__ part, int m_total, int n_out, int t_len, int c_in, int kd,
                  int pad, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int kk0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile, s = blockIdx.z;
  const int m_begin = s * chunk;
  WgradLoad load;
  load.g = g;
  load.x = x;
  load.t_len = t_len;
  load.tc = t_len * c_in;
  load.m_end = min(m_total, m_begin + chunk);
  load.init(m_begin, n_out, n0, kk0, kd, c_in, pad);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int rows = load.m_end - m_begin;
  mainloop(smem, load, rows > 0 ? (rows + kDepth - 1) / kDepth : 0, acc);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* p = part + static_cast<long long>(s) * n_out * kd;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int nn = n0 + sub(ty, i);
    if (nn >= n_out) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kk = kk0 + sub(tx, j);
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

}  // namespace

// The kernels' shared memory is dynamic, allowed above 48 KB on the current
// device before each launch.
extern "C" {

// The tiling the wrapper sizes its operands by: {rows and columns of a
// block's tile, reduction depth of a stage, resident blocks an SM}.
void conv_tiling(int* out) {
  out[0] = kTile;
  out[1] = kDepth;
  out[2] = kMinBlocks;
}

// x: (B, T, Cin) as m_total = B T rows; w: (kpad, npad) panel; bias: (n,) or
// null; out: (B, T, n).  kd = K Cin; kpad a multiple of the depth, npad of
// the tile.
int conv_fwd_f32(const float* x, const float* w, const float* bias, float* out, int m_total,
                 int n, int npad, int t_len, int c_in, int kd, int kpad, int pad, int relu,
                 void* stream) {
  const cudaError_t set = cudaFuncSetAttribute(
      conv_unfold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(npad / kTile, (m_total + kTile - 1) / kTile);
  conv_unfold_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, out, m_total, n, npad, t_len, c_in, kd, kpad, pad, relu);
  return static_cast<int>(cudaGetLastError());
}

// g: (B, T, n_out); x: (B, T, Cin); part: (splits, n_out, k_w Cin) scratch;
// dw: (n_out, Cin, k_w).  Slice s holds rows [s chunk, (s + 1) chunk).
int conv_wgrad_f32(const float* g, const float* x, float* part, float* dw, int m_total,
                   int n_out, int t_len, int c_in, int k_w, int pad, int splits, int chunk,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t set = cudaFuncSetAttribute(
      conv_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int kd = k_w * c_in;
  const dim3 grid((kd + kTile - 1) / kTile, (n_out + kTile - 1) / kTile, splits);
  conv_wgrad_kernel<<<grid, kThreads, kSmemBytes, st>>>(g, x, part, m_total, n_out, t_len,
                                                         c_in, kd, pad, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long size = static_cast<long long>(n_out) * kd;
  conv_wgrad_sum_kernel<<<static_cast<unsigned>((size + kThreads - 1) / kThreads), kThreads, 0,
                          st>>>(part, dw, splits, n_out, c_in, k_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
