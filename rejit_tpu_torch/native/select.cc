// Native host helpers of rejit_tpu_torch: the port's own copy of the JAX
// package's native/select.cc, with the same functions and results.
//
// On the card the match loop runs in CUDA kernels; what stays on the host
// CPU is (a) the sequential non-overlap selection over the sparse
// candidate list (docs/SEMANTICS.md MatchAll), (b) the replacement splices
// of Replace / replace_each, and (c) scalar DFA runs and line lookups for
// tools. They are compiled at first use and loaded with ctypes
// (rejit_tpu_torch/native/lib.py).
//
// Build: python -m rejit_tpu_torch.native.build   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>

extern "C" {

// Greedy non-overlap selection over the dense L/I arrays (length n+1).
// Returns the number of matches written (<= capacity).
int64_t rtn_select_matches(const int64_t* L, const int64_t* I, int64_t n,
                           int64_t* out_starts, int64_t* out_ends,
                           int64_t* out_pids, int64_t cap) {
  int64_t cnt = 0;
  int64_t pos = 0;
  while (pos <= n && cnt < cap) {
    // Find next candidate >= pos.
    while (pos <= n && L[pos] < 0) pos++;
    if (pos > n) break;
    int64_t s = pos;
    int64_t e = L[s];
    out_starts[cnt] = s;
    out_ends[cnt] = e;
    out_pids[cnt] = I[s];
    cnt++;
    pos = (e > s) ? e : s + 1;
  }
  return cnt;
}

// Greedy non-overlap selection over compacted candidates (pos sorted asc).
int64_t rtn_select_candidates(const int32_t* pos, const int32_t* end,
                              const int32_t* pid, int64_t k,
                              int64_t* out_starts, int64_t* out_ends,
                              int64_t* out_pids, int64_t cap) {
  int64_t cnt = 0;
  int64_t cur = 0;
  int64_t i = 0;
  while (i < k && cnt < cap) {
    int64_t s = pos[i];
    int64_t e = end[i];
    out_starts[cnt] = s;
    out_ends[cnt] = e;
    out_pids[cnt] = pid[i];
    cnt++;
    cur = (e > s) ? e : s + 1;
    // Advance: candidates are sorted by position; linear scan is optimal
    // here because the skipped range was just covered by the match.
    while (i < k && pos[i] < cur) i++;
  }
  return cnt;
}

// Scalar anchored longest-match from position s over compiled tables
// (verification / fallback; mirrors engine/reference.py l_array_naive).
// Returns end boundary or -1; *out_pid gets the accepting pattern id.
int64_t rtn_dfa_longest(const uint8_t* text, int64_t n, int64_t s,
                        const uint8_t* class_of, const int32_t* next_tab,
                        const int16_t* accept_tab, const int16_t* accept_eot,
                        int32_t n_classes, int32_t start_state,
                        int32_t dead_state, int32_t* out_pid) {
  int32_t q = start_state;
  int64_t best = -1;
  int32_t best_pid = -1;
  for (int64_t posn = s; posn <= n; posn++) {
    int32_t a;
    if (posn < n) {
      a = accept_tab[q * n_classes + class_of[text[posn]]];
    } else {
      a = accept_eot[q];
    }
    if (a >= 0) {
      best = posn;
      best_pid = a;
    }
    if (posn == n || q == dead_state) break;
    q = next_tab[q * n_classes + class_of[text[posn]]];
  }
  *out_pid = best_pid;
  return best;
}

// Count lines and find line starts containing match spans (jrep support):
// for each match start, locate its line number and line bounds.
// lines_idx must have capacity n_matches.
void rtn_line_of_offsets(const uint8_t* text, int64_t n,
                         const int64_t* offsets, int64_t n_offsets,
                         int64_t* line_no, int64_t* line_start,
                         int64_t* line_end) {
  int64_t line = 0;
  int64_t start = 0;
  int64_t oi = 0;
  for (int64_t i = 0; i <= n && oi < n_offsets; i++) {
    if (i == n || text[i] == '\n') {
      while (oi < n_offsets && offsets[oi] <= i) {
        line_no[oi] = line;
        line_start[oi] = start;
        line_end[oi] = i;
        oi++;
      }
      line++;
      start = i + 1;
    }
  }
}

}  // extern "C"

extern "C" {
// Replacement splice: copy `text` with each [starts[i], ends[i]) span
// replaced by `rep` (replen bytes). Spans are sorted and non-overlapping
// (MatchAll output). `out` capacity: n + k*replen - sum(ends-starts).
// Returns bytes written.
int64_t rtn_replace_splice(const uint8_t* text, int64_t n,
                           const int64_t* starts, const int64_t* ends,
                           int64_t k, const uint8_t* rep, int64_t replen,
                           uint8_t* out) {
  int64_t o = 0, pos = 0;
  for (int64_t i = 0; i < k; i++) {
    int64_t s = starts[i], e = ends[i];
    memcpy(out + o, text + pos, (size_t)(s - pos));
    o += s - pos;
    memcpy(out + o, rep, (size_t)replen);
    o += replen;
    pos = e;
  }
  memcpy(out + o, text + pos, (size_t)(n - pos));
  o += n - pos;
  return o;
}

// Per-pattern replacement splice: span i is replaced by the pattern-id-
// selected replacement reps[rep_off[pids[i]] .. +rep_len[pids[i]]).
// One pass over the text regardless of how many patterns are involved
// (the regexdna IUB phase runs 11 single-class patterns this way instead
// of 11 sequential Replace passes).
int64_t rtn_replace_splice_multi(const uint8_t* text, int64_t n,
                                 const int64_t* starts, const int64_t* ends,
                                 const int64_t* pids, int64_t k,
                                 const uint8_t* reps, const int64_t* rep_off,
                                 const int64_t* rep_len, uint8_t* out) {
  int64_t o = 0, pos = 0;
  for (int64_t i = 0; i < k; i++) {
    int64_t s = starts[i], e = ends[i];
    memcpy(out + o, text + pos, (size_t)(s - pos));
    o += s - pos;
    int64_t pid = pids[i];
    memcpy(out + o, reps + rep_off[pid], (size_t)rep_len[pid]);
    o += rep_len[pid];
    pos = e;
  }
  memcpy(out + o, text + pos, (size_t)(n - pos));
  o += n - pos;
  return o;
}
}  // extern "C"
