// Native CPU reference engine and corpus packer.
//
// The reference's hot host path is a sequential per-byte HashMap scan in
// Rust (reference: src/lib.rs:804-888). This is its native C++ equivalent
// operating on the framework's dense tables — used as (a) a fast
// conformance oracle for large-scale fuzzing against the TPU kernels and
// (b) the host-side corpus loader that packs newline-delimited corpora
// into padded device batches. Exposed through a C ABI for ctypes.
//
// Build: see build.py (g++ -O3 -march=native -shared -fPIC [-fopenmp]).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Sequential DFA scan over a padded batch.
//   chars:      [batch, max_len] input bytes
//   lengths:    [batch]
//   transition: [256, s] dense next-state table (DEAD-completed)
//   states_out: [batch, max_len + 1]; row `len` keeps the final state and
//               rows beyond carry `dummy_state` (lib.rs:404-418 semantics)
void h2r_scan_states(const uint8_t* chars, const int32_t* lengths,
                     int64_t batch, int64_t max_len, const int32_t* transition,
                     int32_t s, int32_t first_state, int32_t dummy_state,
                     int32_t* states_out) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < batch; ++b) {
    const uint8_t* row = chars + b * max_len;
    int32_t* out = states_out + b * (max_len + 1);
    int32_t st = first_state;
    out[0] = st;
    int64_t len = lengths[b];
    for (int64_t i = 0; i < len; ++i) {
      st = transition[(int64_t)row[i] * s + st];
      out[i + 1] = st;
    }
    for (int64_t i = len + 1; i <= max_len; ++i) out[i] = dummy_state;
  }
}

// Substring-id tagging + start/end flags for one def.
//   states:        [batch, max_len + 1] from h2r_scan_states
//   substr_table:  [s, s]  (cur, next) -> global substr id (0 = none)
//   is_start_tab / is_end_tab: [n_ids, s] membership tables (row 0 zero)
//   ids_out:       [batch, max_len]
//   is_start_out / is_end_out: [batch, max_len + 1] (is_end right-shifted)
void h2r_substr_scan(const int32_t* states, const int32_t* lengths,
                     int64_t batch, int64_t max_len, const int32_t* substr_table,
                     int32_t s, const uint8_t* is_start_tab,
                     const uint8_t* is_end_tab, int64_t n_ids,
                     int32_t* ids_out, int32_t* is_start_out,
                     int32_t* is_end_out) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < batch; ++b) {
    const int32_t* st = states + b * (max_len + 1);
    int32_t* ids = ids_out + b * max_len;
    int32_t* iso = is_start_out + b * (max_len + 1);
    int32_t* ieo = is_end_out + b * (max_len + 1);
    int64_t len = lengths[b];
    std::memset(ids, 0, sizeof(int32_t) * max_len);
    std::memset(iso, 0, sizeof(int32_t) * (max_len + 1));
    std::memset(ieo, 0, sizeof(int32_t) * (max_len + 1));
    for (int64_t i = 0; i < len; ++i) {
      int32_t id = substr_table[(int64_t)st[i] * s + st[i + 1]];
      ids[i] = id;
      iso[i] = is_start_tab[(int64_t)id * s + st[i]];
      ieo[i + 1] = is_end_tab[(int64_t)id * s + st[i + 1]];
    }
  }
}

// Forward + backward set/reset/hold mask FSMs over summed columns
// (lib.rs:598-714). All arrays [batch, max_len] except the flag sums which
// are [batch, max_len + 1].
void h2r_mask_fsm(const int32_t* id_sum, const int32_t* is_start_sum,
                  const int32_t* is_end_sum, int64_t batch, int64_t max_len,
                  int32_t* fwd_out, int32_t* bwd_out, int32_t* mask_out) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < batch; ++b) {
    const int32_t* ids = id_sum + b * max_len;
    const int32_t* iss = is_start_sum + b * (max_len + 1);
    const int32_t* ies = is_end_sum + b * (max_len + 1);
    int32_t* fwd = fwd_out + b * max_len;
    int32_t* bwd = bwd_out + b * max_len;
    int32_t* msk = mask_out + b * max_len;
    int32_t last = 0;
    for (int64_t i = 0; i < max_len; ++i) {
      int32_t pre = (i > 0) ? ids[i - 1] : 0;
      bool changed = pre != ids[i];
      bool set_f = iss[i] && changed;
      bool reset_f = !iss[i] && ies[i] && changed;
      last = set_f ? 1 : (reset_f ? 0 : last);
      fwd[i] = last;
    }
    last = 0;
    for (int64_t idx = 0; idx < max_len; ++idx) {
      int64_t j = max_len - 1 - idx;
      int32_t pre = (idx > 0) ? ids[j + 1] : 0;
      bool changed = pre != ids[j];
      bool set_f = ies[j + 1] && changed;
      bool reset_f = !ies[j + 1] && iss[j + 1] && changed;
      last = set_f ? 1 : (reset_f ? 0 : last);
      bwd[j] = last;
    }
    for (int64_t i = 0; i < max_len; ++i) msk[i] = fwd[i] & bwd[i];
  }
}

// Corpus packer: split a newline-delimited buffer into a padded batch.
// Pass 1 (count_only=1): returns the number of lines; out buffers unused.
// Pass 2: fills chars_out [n, max_len] and lengths_out [n]; lines longer
// than max_len are truncated (truncated count returned via *n_truncated).
// keep_newline restores each terminated line's '\n' byte (lines split on
// '\n'; the final unterminated line is unchanged) — the email-header DFAs
// need the full \r\n ending to reach their accept state.
int64_t h2r_pack_lines(const uint8_t* data, int64_t data_len, int64_t max_len,
                       int32_t count_only, uint8_t* chars_out,
                       int32_t* lengths_out, int64_t* n_truncated,
                       int32_t keep_newline) {
  // The serial memchr loop tops out ~1-2 GB/s while the device scan runs
  // 20-50 GB/s, making packing the corpus-job bottleneck.  Parallel form:
  // block-local newline counts -> exclusive scan -> block-parallel
  // position fill -> line-parallel copy.
  const int64_t BLK = 1 << 20;
  const int64_t n_blk = data_len > 0 ? (data_len + BLK - 1) / BLK : 0;
  std::vector<int64_t> counts(n_blk + 1, 0);
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < n_blk; ++b) {
    const uint8_t* p = data + b * BLK;
    const uint8_t* end = data + std::min(data_len, (b + 1) * BLK);
    int64_t c = 0;
    while ((p = (const uint8_t*)memchr(p, '\n', end - p)) != nullptr) {
      ++c;
      ++p;
    }
    counts[b + 1] = c;
  }
  for (int64_t b = 0; b < n_blk; ++b) counts[b + 1] += counts[b];
  int64_t n_nl = n_blk ? counts[n_blk] : 0;
  // final unterminated line (buffer not ending in '\n') is one more row
  bool tail_line = data_len > 0 && data[data_len - 1] != '\n';
  int64_t n = n_nl + (tail_line ? 1 : 0);
  if (count_only) return n;

  std::vector<int64_t> nl_pos(n_nl);
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < n_blk; ++b) {
    const uint8_t* base = data;
    const uint8_t* p = data + b * BLK;
    const uint8_t* end = data + std::min(data_len, (b + 1) * BLK);
    int64_t w = counts[b];
    while ((p = (const uint8_t*)memchr(p, '\n', end - p)) != nullptr) {
      nl_pos[w++] = p - base;
      ++p;
    }
  }

  int64_t truncated = 0;
#pragma omp parallel for schedule(static) reduction(+ : truncated)
  for (int64_t r = 0; r < n; ++r) {
    int64_t start = r == 0 ? 0 : nl_pos[r - 1] + 1;
    bool terminated = r < n_nl;
    int64_t stop = terminated ? nl_pos[r] : data_len;
    int64_t len = stop - start;
    if (keep_newline && terminated) ++len;  // the '\n' at data[stop]
    int64_t copy = len < max_len ? len : max_len;
    if (len > max_len) ++truncated;
    std::memcpy(chars_out + r * max_len, data + start, copy);
    std::memset(chars_out + r * max_len + copy, 0, max_len - copy);
    lengths_out[r] = (int32_t)copy;
  }
  if (n_truncated) *n_truncated = truncated;
  return n;
}

int h2r_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
