// The matmul tier's alpha and beta chains in one pass over E = exp(T - c)
// per paired step (kernel K9).
//
// Replaces: torch_asg_tpu/ops/pallas/bigvocab_kernels.py::_dual_kernel
// (launched by fcc_dual_streams).  Its outputs are the contract: the
// log-domain streams alpha, beta (T, B, N) of the two matmul-tier scans.
//
// Paired step st = 0 .. T-2 advances alpha to frame st+1 and beta to frame
// T-2-st.  With exp-domain rows xa = pa (alpha) and xb = pb * exp(I - rowmax)
// (beta, the emission of frame T-1-st folded in):
//   acc_a[b, i] = sum_j E[i, j] xa[b, j]     (alpha contracts E's columns)
//   acc_b[b, i] = sum_j E[j, i] xb[b, j]     (beta contracts E's rows)
//   pa = acc_a * exp(I[st+1] - rowmax) / max,  alpha[st+1] = log pa + offa
//   pb = acc_b / max (1 where L_in - 1 == T-2-st), beta[T-2-st] = log pb + offb
// and the offsets collect the row maxes, log maxes and c (a zero row keeps
// max 1, so log 0 = -inf is alpha's value and no 0 * inf arises).
//
// What bounds it on an H100: bytes.  E is N^2 elements (400 MB at N = 10,000
// in float32, eight times the 50 MB L2), so every paired step streams it
// from device memory; each step's 4 B N^2 operations are fewer than the
// card's float32 rate does in that time.  The design reads E once per
// paired step for both chains:
//   - dual_tile_kernel: a block of 4 warps takes 512 columns of a range of
//     rows; the grid is one full wave of resident blocks (so no second,
//     nearly empty wave), the row ranges as even as N allows.  Lane l of
//     warp w owns the columns strip + l + 32 k (k < 4), so each load of a
//     row is one coalesced 128-element access, with xa for its columns in
//     registers.  For each row it adds E * xb[row] into per-column beta
//     sums (registers) and forms its share of alpha's row sum, which a
//     transposing warp reduction (9 shuffles for the 8 batch elements)
//     completes.  Partials go to a scratch: beta's per row range, alpha's
//     per column block after a fixed-order sum over the 4 warps in shared
//     memory, one chunk of 256 rows (128 in float64) at a time.
//   - dual_reduce_kernel sums the partials in a fixed order (no atomics:
//     two runs give the same bits), applies alpha's emission and takes
//     per-block row maxima;
//   - dual_finish_kernel rescales, writes the log-domain rows, re-seeds
//     beta and forms the next step's xa and xb.
// Three launches per paired step from one host loop.  Batches wider than 8
// take one pass over E per group of 8.

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 4;                     // column strips per tile block
constexpr int kCols = 4;                      // columns per lane
constexpr int kStrip = kLanes * kCols;        // columns per warp
constexpr int kTileCols = kWarps * kStrip;    // columns per tile block
constexpr int kGroup = 8;                     // batch elements per pass over E
constexpr int kThreads = 256;                 // reduce, finish and row-max blocks

template <typename T> struct TileRows { static constexpr int value = 256; };
template <> struct TileRows<double> { static constexpr int value = 128; };

template <typename T>
__device__ __forceinline__ T neg_inf() { return static_cast<T>(-INFINITY); }

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum of v[b] over the 32 lanes for the 8 batch elements at once.  Each
// step keeps half of the values and trades the other half with the partner
// lane, so lane l ends with the total for batch element
// 4 bit4(l) + 2 bit3(l) + bit2(l).
template <typename T>
__device__ __forceinline__ T warp_sum8(const T (&v)[kGroup], int lane) {
  const unsigned full = 0xffffffffu;
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  T w4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w4[i] = (h16 ? v[i + 4] : v[i]) + __shfl_xor_sync(full, h16 ? v[i] : v[i + 4], 16);
  T w2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    w2[i] = (h8 ? w4[i + 2] : w4[i]) + __shfl_xor_sync(full, h8 ? w4[i] : w4[i + 2], 8);
  T y = (h4 ? w2[1] : w2[0]) + __shfl_xor_sync(full, h4 ? w2[0] : w2[1], 4);
  y += __shfl_xor_sync(full, y, 2);
  y += __shfl_xor_sync(full, y, 1);
  return y;
}

// Max of count non-negative values, computed by every warp on its own.
template <typename T>
__device__ __forceinline__ T max_of(const T* __restrict__ v, int count) {
  T m = 0;
  for (int k = threadIdx.x % kLanes; k < count; k += kLanes) m = fmax(m, v[k]);
  return warp_max(m);
}

// rmax[t, b] = max_i I[t, b, i], 0 when it is not finite.  Grid: T * B.
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_max_kernel(const T* __restrict__ em, T* __restrict__ rmax, int n) {
  __shared__ T red[kThreads / kLanes];
  const T* row = em + (size_t)blockIdx.x * n;
  T m = neg_inf<T>();
  for (int i = threadIdx.x; i < n; i += kThreads) m = fmax(m, row[i]);
  m = warp_max(m);
  if (threadIdx.x % kLanes == 0) red[threadIdx.x / kLanes] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / kLanes; ++w) m = fmax(m, red[w]);
    rmax[blockIdx.x] = isfinite(m) ? m : T(0);
  }
}

// The chains' boundary rows and first inputs.  Grid: (ceil(N / 256), B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dual_init_kernel(const T* __restrict__ em, const T* __restrict__ rmax,
                 const int* __restrict__ li, T* __restrict__ xa, T* __restrict__ xb,
                 T* __restrict__ off, T* __restrict__ alpha, T* __restrict__ beta,
                 int t_total, int batch, int n) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool seed = li[b] == t_total;  // beta seeds at T - 1
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    off[b] = rmax[b];
    off[batch + b] = 0;
  }
  if (i >= n) return;
  const size_t o = (size_t)b * n + i;
  const size_t last = (size_t)(t_total - 1) * batch * n + o;
  alpha[o] = em[o];
  xa[o] = exp(em[o] - rmax[b]);
  beta[last] = seed ? T(0) : neg_inf<T>();
  xb[o] = seed ? exp(em[last] - rmax[(size_t)(t_total - 1) * batch + b]) : T(0);
}

constexpr int kAhead = 4;  // rows of E a warp loads ahead of its compute

// E[row0 + r0 + q, col0 + 32 k] for q < kAhead (0 past the chunk or N).
template <typename T>
__device__ __forceinline__ void load_rows(T (&dst)[kAhead][kCols], const T* __restrict__ e,
                                          int row0, int rows, int r0, int col0, int n) {
#pragma unroll
  for (int q = 0; q < kAhead; ++q) {
    const bool live = r0 + q < rows;
    const T* erow = e + (size_t)(row0 + r0 + q) * n;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int col = col0 + k * kLanes;
      dst[q][k] = (live && col < n) ? erow[col] : T(0);
    }
  }
}

// Partials of both contractions.  Grid: (ceil(N / 512), n_rb, ceil(B / 8));
// 4 warps; block y takes rows [y * rpb, (y + 1) * rpb).
template <typename T>
__global__ void __launch_bounds__(kWarps * kLanes, 4)
dual_tile_kernel(const T* __restrict__ e, const T* __restrict__ xa,
                 const T* __restrict__ xb, T* __restrict__ part_a,
                 T* __restrict__ part_b, int batch, int n, int rpb) {
  constexpr int R = TileRows<T>::value;
  __shared__ __align__(16) T xb_s[R * kGroup];
  __shared__ __align__(16) T al_s[kWarps * R * kGroup];
  const int w = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int cb = blockIdx.x, rb = blockIdx.y, b0 = blockIdx.z * kGroup;
  const int row_end = min(n, (rb + 1) * rpb);
  const int col0 = cb * kTileCols + w * kStrip + lane;

  T xa_r[kGroup][kCols], bacc[kGroup][kCols];
#pragma unroll
  for (int b = 0; b < kGroup; ++b) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int col = col0 + k * kLanes;
      xa_r[b][k] = (col < n && b0 + b < batch) ? xa[(size_t)(b0 + b) * n + col] : T(0);
      bacc[b][k] = T(0);
    }
  }
  const int bsel = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);

  for (int row0 = rb * rpb; row0 < row_end; row0 += R) {
    const int rows = min(R, row_end - row0);
    __syncthreads();  // the previous chunk's readers of xb_s and al_s are done
    for (int idx = threadIdx.x; idx < R * kGroup; idx += blockDim.x) {
      const int b = idx / R, r = idx - b * R;
      xb_s[r * kGroup + b] =
          (r < rows && b0 + b < batch) ? xb[(size_t)(b0 + b) * n + row0 + r] : T(0);
    }
    __syncthreads();

    // rows in groups of kAhead, the next group's loads in flight while the
    // current one computes
    T next[kAhead][kCols];
    load_rows<T>(next, e, row0, rows, 0, col0, n);
    for (int r0 = 0; r0 < rows; r0 += kAhead) {
      T ev[kAhead][kCols];
#pragma unroll
      for (int q = 0; q < kAhead; ++q)
#pragma unroll
        for (int k = 0; k < kCols; ++k) ev[q][k] = next[q][k];
      load_rows<T>(next, e, row0, rows, r0 + kAhead, col0, n);
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const int r = r0 + q;
        if (r >= rows) break;
        T v[kGroup];
#pragma unroll
        for (int b = 0; b < kGroup; ++b) {
          T s = ev[q][0] * xa_r[b][0];
#pragma unroll
          for (int k = 1; k < kCols; ++k) s = fma(ev[q][k], xa_r[b][k], s);
          v[b] = s;
          const T x = xb_s[r * kGroup + b];
#pragma unroll
          for (int k = 0; k < kCols; ++k) bacc[b][k] = fma(ev[q][k], x, bacc[b][k]);
        }
        const T y = warp_sum8(v, lane);
        if ((lane & 3) == 0) al_s[(w * R + r) * kGroup + bsel] = y;
      }
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < kGroup * rows; idx += blockDim.x) {
      const int b = idx / rows, r = idx - b * rows;
      if (b0 + b >= batch) break;
      T s = al_s[r * kGroup + b];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) s += al_s[(k * R + r) * kGroup + b];
      part_a[((size_t)cb * batch + b0 + b) * n + row0 + r] = s;
    }
  }
#pragma unroll
  for (int b = 0; b < kGroup; ++b) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int col = col0 + k * kLanes;
      if (col < n && b0 + b < batch)
        part_b[((size_t)rb * batch + b0 + b) * n + col] = bacc[b][k];
    }
  }
}

// Fixed-order sums of the partials; alpha's emission; per-block maxima
// bmax[b, 0, blk] (alpha) and bmax[b, 1, blk] (beta).  Grid: (nblk, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dual_reduce_kernel(const T* __restrict__ part_a, const T* __restrict__ part_b,
                   int n_cb, int n_rb, const T* __restrict__ em_a,
                   const T* __restrict__ rmax_a, T* __restrict__ va,
                   T* __restrict__ vb, T* __restrict__ bmax, int batch, int n) {
  __shared__ T red[2][kThreads / kLanes];
  const int b = blockIdx.y, nblk = gridDim.x;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  T a = 0, bt = 0;
  if (i < n) {
    const size_t o = (size_t)b * n + i, stride = (size_t)batch * n;
    T s = 0;
    for (int k = 0; k < n_cb; ++k) s += part_a[k * stride + o];
    a = s * exp(em_a[o] - rmax_a[b]);
    for (int k = 0; k < n_rb; ++k) bt += part_b[k * stride + o];
    va[o] = a;
    vb[o] = bt;
  }
  a = warp_max(a);
  bt = warp_max(bt);
  if (threadIdx.x % kLanes == 0) {
    red[0][threadIdx.x / kLanes] = a;
    red[1][threadIdx.x / kLanes] = bt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / kLanes; ++w) {
      a = fmax(a, red[0][w]);
      bt = fmax(bt, red[1][w]);
    }
    bmax[((size_t)b * 2) * nblk + blockIdx.x] = a;
    bmax[((size_t)b * 2 + 1) * nblk + blockIdx.x] = bt;
  }
}

// Rescale, write alpha[st+1] and beta[T-2-st], re-seed beta, and form the
// next step's xa, xb.  The offsets ping-pong between two buffers, so every
// block reads the old ones while block 0 writes the new.  Grid: (nblk, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dual_finish_kernel(const T* __restrict__ va, const T* __restrict__ vb,
                   const T* __restrict__ bmax, const T* __restrict__ em,
                   const T* __restrict__ rmax, const T* __restrict__ cptr,
                   const int* __restrict__ li, const T* __restrict__ off_in,
                   T* __restrict__ off_out, T* __restrict__ xa, T* __restrict__ xb,
                   T* __restrict__ alpha, T* __restrict__ beta, int st, int t_total,
                   int batch, int n) {
  const int b = blockIdx.y, nblk = gridDim.x;
  const int ta = st + 1, tb = t_total - 2 - st;
  const T ma = max_of(bmax + (size_t)b * 2 * nblk, nblk);
  const T mb = max_of(bmax + ((size_t)b * 2 + 1) * nblk, nblk);
  const T msa = ma > 0 ? ma : T(1), msb = mb > 0 ? mb : T(1);
  const T inva = T(1) / msa, invb = T(1) / msb;
  const T c = *cptr;
  const bool seed = li[b] - 1 == tb;
  const T offa = off_in[b] + rmax[(size_t)ta * batch + b] + log(msa) + c;
  const T offb = seed ? T(0)
                      : off_in[batch + b] + rmax[(size_t)(tb + 1) * batch + b] + log(msb) + c;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    off_out[b] = offa;
    off_out[batch + b] = offb;
  }
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)b * n + i;
  const T pa = va[o] * inva;
  alpha[(size_t)ta * batch * n + o] = log(pa) + offa;
  xa[o] = pa;
  const T pb = seed ? T(1) : vb[o] * invb;
  const size_t ob = (size_t)tb * batch * n + o;
  beta[ob] = log(pb) + offb;
  // the next step's beta consumes frame tb's emission
  xb[o] = pb * exp(em[ob] - rmax[(size_t)tb * batch + b]);
}

struct Layout {
  int n_cb, n_rb, rpb, n_bg, nblk;
  size_t part_a, part_b, xa, xb, va, vb, off, bmax, rmax, total;
};

// Fewest rows a tile block takes: fewer would write more beta partials than
// the rows of E they save from a second wave.
constexpr int kMinRows = 64;

// The tile grid fills the card's resident blocks once: n_rb row ranges of
// rpb rows each (the last one shorter).  Depends on the current device.
template <typename T>
Layout layout(int t_total, int batch, int n) {
  Layout l;
  l.n_cb = (n + kTileCols - 1) / kTileCols;
  l.n_bg = (batch + kGroup - 1) / kGroup;
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dual_tile_kernel<T>,
                                                kWarps * kLanes, 0);
  const int wave = sms * (per_sm > 0 ? per_sm : 1) / (l.n_cb * l.n_bg);
  const int most = (n + kMinRows - 1) / kMinRows;
  const int n_rb = wave < 1 ? 1 : (wave < most ? wave : most);
  l.rpb = (n + n_rb - 1) / n_rb;
  l.n_rb = (n + l.rpb - 1) / l.rpb;
  l.nblk = (n + kThreads - 1) / kThreads;
  const size_t bn = (size_t)batch * n;
  size_t at = 0;
  l.part_a = at; at += (size_t)l.n_cb * bn;
  l.part_b = at; at += (size_t)l.n_rb * bn;
  l.xa = at; at += bn;
  l.xb = at; at += bn;
  l.va = at; at += bn;
  l.vb = at; at += bn;
  l.off = at; at += 4 * (size_t)batch;  // two buffers of (offa, offb)
  l.bmax = at; at += 2 * (size_t)batch * l.nblk;
  l.rmax = at; at += (size_t)t_total * batch;
  l.total = at;
  return l;
}

#define RETURN_ON_ERROR()                               \
  do {                                                  \
    cudaError_t err_ = cudaGetLastError();              \
    if (err_ != cudaSuccess) return (int)err_;          \
  } while (0)

template <typename T>
int launch_dual(const T* em, const T* e, const T* c, const int* li, T* alpha,
                T* beta, T* scratch, int t_total, int batch, int n, void* stream) {
  if (t_total < 2 || batch < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const Layout l = layout<T>(t_total, batch, n);
  cudaStream_t s = (cudaStream_t)stream;
  T* part_a = scratch + l.part_a;
  T* part_b = scratch + l.part_b;
  T* xa = scratch + l.xa;
  T* xb = scratch + l.xb;
  T* va = scratch + l.va;
  T* vb = scratch + l.vb;
  T* off = scratch + l.off;
  T* bmax = scratch + l.bmax;
  T* rmax = scratch + l.rmax;
  const size_t bn = (size_t)batch * n;
  const dim3 rows_grid(l.nblk, batch);
  const dim3 tile_grid(l.n_cb, l.n_rb, l.n_bg);

  row_max_kernel<T><<<t_total * batch, kThreads, 0, s>>>(em, rmax, n);
  RETURN_ON_ERROR();
  dual_init_kernel<T><<<rows_grid, kThreads, 0, s>>>(em, rmax, li, xa, xb, off, alpha,
                                                      beta, t_total, batch, n);
  RETURN_ON_ERROR();
  for (int st = 0; st < t_total - 1; ++st) {
    dual_tile_kernel<T><<<tile_grid, kWarps * kLanes, 0, s>>>(e, xa, xb, part_a, part_b,
                                                              batch, n, l.rpb);
    RETURN_ON_ERROR();
    dual_reduce_kernel<T><<<rows_grid, kThreads, 0, s>>>(
        part_a, part_b, l.n_cb, l.n_rb, em + (size_t)(st + 1) * bn,
        rmax + (size_t)(st + 1) * batch, va, vb, bmax, batch, n);
    RETURN_ON_ERROR();
    const T* off_in = off + (size_t)(st & 1) * 2 * batch;
    T* off_out = off + (size_t)((st + 1) & 1) * 2 * batch;
    dual_finish_kernel<T><<<rows_grid, kThreads, 0, s>>>(
        va, vb, bmax, em, rmax, c, li, off_in, off_out, xa, xb, alpha, beta, st, t_total,
        batch, n);
    RETURN_ON_ERROR();
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Elements of scratch (of the kernel's type) that fcc_dual_* needs.
long long fcc_dual_scratch_f32(int t_total, int batch, int n) {
  return (long long)layout<float>(t_total, batch, n).total;
}

long long fcc_dual_scratch_f64(int t_total, int batch, int n) {
  return (long long)layout<double>(t_total, batch, n).total;
}

// em: (T, B, N) length-masked emissions; e: (N, N) exp(T - c); c: one
// element on the card; li: (B,) int32; alpha, beta: (T, B, N) outputs.
int fcc_dual_f32(const float* em, const float* e, const float* c, const int* li,
                 float* alpha, float* beta, float* scratch, int t_total, int batch,
                 int n, void* stream) {
  return launch_dual<float>(em, e, c, li, alpha, beta, scratch, t_total, batch, n, stream);
}

int fcc_dual_f64(const double* em, const double* e, const double* c, const int* li,
                 double* alpha, double* beta, double* scratch, int t_total, int batch,
                 int n, void* stream) {
  return launch_dual<double>(em, e, c, li, alpha, beta, scratch, t_total, batch, n, stream);
}

}  // extern "C"
