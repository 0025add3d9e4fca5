// Host-side data path of the PyTorch port, in C++ with OpenMP.
//
// The loop-heavy CPU work around the criterion: ragged-batch packing, the
// ASG extended-alphabet target encoding, per-utterance CMVN and the
// decode-side path collapse.  A training loop runs it on the host while the
// card computes a step (``runtime/prefetch.py``).
//
// Exposed through a plain C ABI and loaded with ctypes
// (``torch_asg_tpu_torch/runtime/host.py``), which builds this file with g++
// at the first native call into ``runtime/build/``:
//   g++ -O3 -fPIC -fopenmp -std=c++17 -shared
// ctypes releases the GIL for the length of each call.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Pack B ragged utterances (concatenated time-major frames, offsets[B+1])
// into a padded (T_max, B, F) tensor filled with pad_value, and emit
// per-utterance lengths.  Layout is time-major to match the criterion's
// (T, B, N) convention.
void asg_pack_frames(const float* frames, const int64_t* offsets,
                     int64_t num_batches, int64_t t_max, int64_t feat_dim,
                     float pad_value, float* out, int32_t* lengths) {
    const int64_t plane = num_batches * feat_dim;
#pragma omp parallel for
    for (int64_t t = 0; t < t_max; ++t) {
        float* row = out + t * plane;
        for (int64_t b = 0; b < num_batches; ++b) {
            const int64_t len = offsets[b + 1] - offsets[b];
            float* dst = row + b * feat_dim;
            if (t < len) {
                const float* src = frames + (offsets[b] + t) * feat_dim;
                std::memcpy(dst, src, sizeof(float) * feat_dim);
            } else {
                std::fill(dst, dst + feat_dim, pad_value);
            }
        }
    }
    for (int64_t b = 0; b < num_batches; ++b) {
        lengths[b] = static_cast<int32_t>(offsets[b + 1] - offsets[b]);
    }
}

// ASG extended-alphabet encoding of one label sequence: collapse runs of a
// repeated label into label + repetition symbols.  Repetition symbol r
// (r in 1..max_reps) has index alphabet_size + r - 1 and means "the
// previous label occurs r additional times"; runs longer than max_reps + 1
// re-emit the base label.  E.g. with max_reps=2: aaa -> a r2; aaaa -> a r2 a.
// Returns the encoded length (<= in_len).
int64_t asg_encode_labels(const int32_t* labels, int64_t in_len,
                          int32_t alphabet_size, int32_t max_reps,
                          int32_t* out) {
    int64_t n = 0;
    int64_t i = 0;
    while (i < in_len) {
        const int32_t lab = labels[i];
        int64_t run = 1;
        while (i + run < in_len && labels[i + run] == lab) ++run;
        int64_t left = run;
        while (left > 0) {
            out[n++] = lab;
            const int64_t reps = std::min<int64_t>(left - 1, max_reps);
            if (reps > 0) {
                out[n++] = alphabet_size + static_cast<int32_t>(reps) - 1;
            }
            left -= 1 + reps;
        }
        i += run;
    }
    return n;
}

// Batched encoding into a padded (B, S_max) int32 matrix (pad_value filled),
// with per-sequence encoded lengths.  Returns the max encoded length.
int64_t asg_encode_batch(const int32_t* labels, const int64_t* offsets,
                         int64_t num_batches, int32_t alphabet_size,
                         int32_t max_reps, int64_t s_max, int32_t pad_value,
                         int32_t* out, int32_t* out_lengths) {
    int64_t global_max = 0;
#pragma omp parallel for reduction(max : global_max)
    for (int64_t b = 0; b < num_batches; ++b) {
        const int64_t in_len = offsets[b + 1] - offsets[b];
        int32_t* row = out + b * s_max;
        std::fill(row, row + s_max, pad_value);
        // encoded length never exceeds input length, which callers bound
        // by s_max.
        const int64_t n =
            asg_encode_labels(labels + offsets[b], in_len, alphabet_size,
                              max_reps, row);
        out_lengths[b] = static_cast<int32_t>(n);
        global_max = std::max(global_max, n);
    }
    return global_max;
}

// Per-utterance cepstral mean (and optionally variance) normalization of
// concatenated ragged frames — the standard wav2letter front-end transform
// applied on the host while the chip computes.  In place; two passes per
// utterance; OpenMP across utterances.
void asg_cmvn(float* frames, const int64_t* offsets, int64_t num_batches,
              int64_t feat_dim, float epsilon, int32_t norm_var) {
#pragma omp parallel for
    for (int64_t b = 0; b < num_batches; ++b) {
        const int64_t beg = offsets[b];
        const int64_t len = offsets[b + 1] - beg;
        if (len <= 0) continue;
        float* base = frames + beg * feat_dim;
        for (int64_t f = 0; f < feat_dim; ++f) {
            double sum = 0.0, sq = 0.0;
            for (int64_t t = 0; t < len; ++t) {
                const double v = base[t * feat_dim + f];
                sum += v;
                sq += v * v;
            }
            const double mean = sum / static_cast<double>(len);
            double scale = 1.0;
            if (norm_var) {
                const double var =
                    std::max(sq / static_cast<double>(len) - mean * mean, 0.0);
                scale = 1.0 / std::sqrt(var + static_cast<double>(epsilon));
            }
            for (int64_t t = 0; t < len; ++t) {
                float* v = base + t * feat_dim + f;
                *v = static_cast<float>((*v - mean) * scale);
            }
        }
    }
}

// Decode-side: collapse consecutive duplicate frame labels and drop
// padding (-1) — turns a Viterbi frame path into a label sequence.
// Expands repetition symbols back into repeated base labels when
// alphabet_size > 0 and the label is a repetition symbol.
int64_t asg_collapse_path(const int32_t* path, int64_t t_len,
                          int32_t alphabet_size, int32_t max_reps,
                          int32_t* out) {
    int64_t n = 0;
    int32_t prev = -1;
    for (int64_t t = 0; t < t_len; ++t) {
        const int32_t lab = path[t];
        if (lab < 0) continue;  // padding
        if (lab == prev) continue;  // collapse the run
        prev = lab;
        if (alphabet_size > 0 && lab >= alphabet_size &&
            lab < alphabet_size + max_reps) {
            // repetition symbol: expand to copies of the previous base label
            const int32_t reps = lab - alphabet_size + 1;
            if (n > 0) {
                const int32_t base = out[n - 1];
                for (int32_t r = 0; r < reps; ++r) out[n++] = base;
            }
        } else {
            out[n++] = lab;
        }
    }
    return n;
}

}  // extern "C"
