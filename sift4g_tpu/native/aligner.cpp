// Native batch aligner: affine-gap DP with full traceback (SW/NW/HW/OV).
//
// Produces the edit paths for the <= max_alignments E-value survivors per
// query — the role swsharp's reconstruct/traceback plays after its scoring
// kernels (the device kernels here are score-only; paths for the
// few hundred kept pairs are cheapest on host).  Semantics are a line-for-
// line mirror of the Python oracle align_pair (sift4g_tpu/align/dp_numpy.py):
// SW#-style affine gaps (gap of length L costs open + (L-1)*extend), the
// same mode boundary conditions, and the same deterministic traceback tie
// order DIAG > LEFT(E) > UP(F).
//
// Move encoding matches align/records.py: 0 = DIAG, 1 = LEFT (gap in
// query, consumes target), 2 = UP (gap in target, consumes query).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "sw_simd.h"

namespace {

constexpr int32_t NEG = INT32_MIN / 4;

enum Mode { SW = 0, NW = 1, HW = 2, OV = 3 };

struct AlignResult {
  int32_t score;
  int32_t query_start, query_end;    // end inclusive
  int32_t target_start, target_end;  // end inclusive
  std::vector<uint8_t> moves;
};

struct DpBuffers {
  std::vector<int32_t> H;      // the ONLY stored matrix (scalar path)
  std::vector<int32_t> Frow;   // rolling F row for the fill
  std::vector<int32_t> e_row;  // lazily rebuilt E row (traceback)
  std::vector<int32_t> f_col;  // lazily rebuilt F column (traceback)
  std::vector<int16_t> hcols;  // striped per-column H (SIMD path)
  std::vector<int16_t> colmax; // per-column max of hcols
  sift4g_simd::Striped16Buffers sbuf;
};

// Traceback from (ei, ej), generic over the H accessor (scalar int32
// matrix or striped int16 columns).  Tie order DIAG > E > F, identical to
// dp_numpy.py align_pair.  E and F are rebuilt lazily: E(i, .) is one
// left-to-right pass over H row i, F(., j) one top-down pass over H
// column j — the fill's own recurrence replayed on the final (write-once)
// H values, so every compared value is bit-identical to a stored-matrix
// version.  A row/column is rebuilt at most once per visit (cached).
template <class HAcc>
void traceback_from(HAcc HA, int ei, int ej, int m, int n, const uint8_t* q,
                    const uint8_t* t, const int32_t* mat, int go, int ge,
                    int mode, int32_t score, AlignResult* out,
                    DpBuffers* buf) {
  const bool local = mode == SW;
  std::vector<uint8_t>& moves = out->moves;
  moves.clear();
  int i = ei, j = ej;
  int state = 0;  // 0 = H, 1 = E, 2 = F
  std::vector<int32_t>& e_row = buf->e_row;
  std::vector<int32_t>& f_col = buf->f_col;
  e_row.resize(n + 1);
  f_col.resize(m + 1);
  int e_valid = -1, f_valid = -1;
  auto EA = [&](int a, int b) {
    if (e_valid != a) {
      int32_t e = NEG;
      for (int jj = 1; jj <= n; ++jj) {
        e = std::max(HA(a, jj - 1) - go, e - ge);
        e_row[jj] = e;
      }
      e_valid = a;
    }
    return e_row[b];
  };
  auto FA = [&](int a, int b) {
    if (f_valid != b) {
      int32_t f = NEG;
      for (int ii = 1; ii <= m; ++ii) {
        f = std::max(HA(ii - 1, b) - go, f - ge);
        f_col[ii] = f;
      }
      f_valid = b;
    }
    return f_col[a];
  };
  for (;;) {
    if (state == 0) {
      if (i == 0 || j == 0) break;
      if (local && HA(i, j) == 0) break;
      int32_t diag = HA(i - 1, j - 1) + mat[q[i - 1] * 26 + t[j - 1]];
      if (HA(i, j) == diag) {
        moves.push_back(0);
        --i; --j;
      } else if (HA(i, j) == EA(i, j)) {
        state = 1;
      } else if (HA(i, j) == FA(i, j)) {
        state = 2;
      } else {
        break;  // boundary-derived (free end gaps)
      }
    } else if (state == 1) {
      moves.push_back(1);
      --j;
      state = (j > 0 && EA(i, j + 1) == EA(i, j) - ge) ? 1 : 0;
    } else {
      moves.push_back(2);
      --i;
      state = (i > 0 && FA(i + 1, j) == FA(i, j) - ge) ? 2 : 0;
    }
  }
  std::reverse(moves.begin(), moves.end());
  if (mode == NW) {
    // python order: UP-gaps prepended first, then LEFT-gaps prepended
    // before them -> final prefix is LEFT^j then UP^i
    std::vector<uint8_t> prefix;
    for (int x = 0; x < j; ++x) prefix.push_back(1);
    for (int x = 0; x < i; ++x) prefix.push_back(2);
    moves.insert(moves.begin(), prefix.begin(), prefix.end());
    i = 0;
    j = 0;
  } else if (mode == HW) {
    moves.insert(moves.begin(), static_cast<size_t>(i), 2);
    i = 0;
  }
  out->score = score;
  out->query_start = i;
  out->query_end = ei - 1;
  out->target_start = j;
  out->target_end = ej - 1;
}

void align_one(const uint8_t* q, int m, const uint8_t* t, int n,
               const int32_t* mat /* 26x26 */, int go, int ge, int mode,
               AlignResult* out, DpBuffers* buf) {
  const int w = n + 1;
  const size_t cells = static_cast<size_t>(m + 1) * w;
  // Only H is materialized: E and F are single-row/column recurrences in
  // their own axis (E(i,j) depends only on H[i][<j]; F(i,j) only on
  // H[<i][j]), so the traceback rebuilds the one row/column it walks
  // instead of storing full matrices — 3x less memory and no full-matrix
  // NEG pre-fill (the old assign() wrote 36 bytes/cell before the DP even
  // started).  Values and tie order are bit-identical to the stored-E/F
  // version (property-tested vs the oracle, moves included).
  std::vector<int32_t>& H = buf->H;
  H.resize(cells);
  std::vector<int32_t>& Frow = buf->Frow;
  Frow.assign(w, NEG);

  H[0] = 0;
  for (int j = 1; j <= n; ++j)
    H[j] = (mode == NW) ? -(go + (j - 1) * ge) : 0;
  for (int i = 1; i <= m; ++i)
    H[static_cast<size_t>(i) * w] =
        (mode == NW || mode == HW) ? -(go + (i - 1) * ge) : 0;

  const bool local = mode == SW;
  for (int i = 1; i <= m; ++i) {
    int32_t* Hi = H.data() + static_cast<size_t>(i) * w;
    int32_t* Hp = H.data() + static_cast<size_t>(i - 1) * w;
    const int32_t* srow = mat + static_cast<size_t>(q[i - 1]) * 26;
    int32_t e = NEG;
    int32_t diag = Hp[0];
    for (int j = 1; j <= n; ++j) {
      int32_t f = std::max(Hp[j] - go, Frow[j] - ge);
      Frow[j] = f;
      int32_t g = std::max(diag + srow[t[j - 1]], f);
      diag = Hp[j];
      if (local) g = std::max(g, 0);
      e = std::max(Hi[j - 1] - go, e - ge);
      Hi[j] = std::max(g, e);
    }
  }

  // endpoint
  int ei, ej;
  int32_t score;
  if (mode == NW) {
    ei = m; ej = n; score = H[static_cast<size_t>(m) * w + n];
  } else if (mode == SW) {
    size_t best = 0;
    for (size_t x = 1; x < H.size(); ++x)
      if (H[x] > H[best]) best = x;  // first max wins (argmax semantics)
    ei = static_cast<int>(best / w);
    ej = static_cast<int>(best % w);
    score = H[best];
  } else if (mode == HW) {
    ei = m; ej = 0;
    const int32_t* Hm = H.data() + static_cast<size_t>(m) * w;
    for (int j = 1; j <= n; ++j)
      if (Hm[j] > Hm[ej]) ej = j;
    score = Hm[ej];
  } else {  // OV
    int bj = 0;
    const int32_t* Hm = H.data() + static_cast<size_t>(m) * w;
    for (int j = 1; j <= n; ++j)
      if (Hm[j] > Hm[bj]) bj = j;
    int bi = 0;
    for (int i = 1; i <= m; ++i)
      if (H[static_cast<size_t>(i) * w + n] > H[static_cast<size_t>(bi) * w + n]) bi = i;
    if (Hm[bj] >= H[static_cast<size_t>(bi) * w + n]) {
      ei = m; ej = bj; score = Hm[bj];
    } else {
      ei = bi; ej = n; score = H[static_cast<size_t>(bi) * w + n];
    }
  }

  traceback_from(
      [&](int a, int b) { return H[static_cast<size_t>(a) * w + b]; },
      ei, ej, m, n, q, t, mat, go, ge, mode, score, out, buf);
}

// SW traceback via the striped AVX2 int16 fill (sw_simd.cpp): ~17x the
// scalar H fill per thread.  Exact under the int16 guard the score path
// already uses (min(m, n) * max|sub| < 30000); per-column striped H is
// final after lazy-F, and the traceback de-stripes on access.  Moves are
// bit-identical to the scalar path (same traceback_from, same values) —
// property-tested in tests/test_native_aligner.py.
void align_one_striped(const sift4g_simd::Profile16& prof, const uint8_t* q,
                       int m, const uint8_t* t, int n, const int32_t* mat,
                       int go, int ge, AlignResult* out, DpBuffers* buf) {
  const int seg_len = prof.seg_len;
  const size_t row = static_cast<size_t>(seg_len) * 16;
  buf->hcols.resize(static_cast<size_t>(n) * row);
  buf->colmax.resize(n);
  int32_t best = sift4g_simd::sw_striped16_cols(
      prof, t, n, go, ge, &buf->sbuf, buf->hcols.data());
  const int16_t* hc = buf->hcols.data();
  // per-column maxes for the endpoint search (pad lanes hold 0 <= any
  // positive max; the best <= 0 case never reads them)
  for (int j = 0; j < n; ++j) {
    int16_t cm = 0;
    const int16_t* col = hc + static_cast<size_t>(j) * row;
    for (size_t x = 0; x < row; ++x) cm = std::max(cm, col[x]);
    buf->colmax[j] = cm;
  }
  auto HA = [&](int a, int b) -> int32_t {
    if (a == 0 || b == 0) return 0;  // SW free boundaries
    int p = a - 1;
    return hc[static_cast<size_t>(b - 1) * row +
              static_cast<size_t>(p % seg_len) * 16 + p / seg_len];
  };
  // endpoint: the scalar path scans H row-major with strict '>' — the
  // FIRST cell holding the global max wins, i.e. the lexicographically
  // smallest (i, j) among max cells
  int ei = 0, ej = 0;
  int32_t score = 0;
  if (best > 0) {
    score = best;
    int bi = m + 1, bj = 0;
    for (int j = 1; j <= n; ++j) {
      if (buf->colmax[j - 1] != best) continue;
      for (int p = 0; p < m; ++p) {
        if (hc[static_cast<size_t>(j - 1) * row +
               static_cast<size_t>(p % seg_len) * 16 + p / seg_len] == best) {
          if (p + 1 < bi) { bi = p + 1; bj = j; }
          break;
        }
      }
    }
    ei = bi; ej = bj;
  }
  traceback_from(HA, ei, ej, m, n, q, t, mat, go, ge, SW, score, out, buf);
}

// Score-only affine DP in linear memory (two rolling rows) — the CPU twin
// of the device scoring kernels (no traceback matrices, no O(mn) memory).
// Same recurrences and mode boundaries as align_one / the GPU kernel;
// bit-identical scores (property-tested).
int32_t score_one(const uint8_t* q, int m, const uint8_t* t, int n,
                  const int32_t* mat, int go, int ge, int mode,
                  std::vector<int32_t>* hbuf, std::vector<int32_t>* fbuf) {
  const bool local = mode == SW;
  const bool free_top = mode != NW;
  const bool free_left = mode == SW || mode == OV;
  std::vector<int32_t>& H = *hbuf;
  std::vector<int32_t>& F = *fbuf;
  H.assign(n + 1, 0);
  F.assign(n + 1, NEG);
  if (!free_top)
    for (int j = 1; j <= n; ++j) H[j] = -(go + (j - 1) * ge);
  int32_t best = local ? 0 : NEG;
  int32_t last_col_best = free_top ? 0 : NEG;  // OV: H[0][n] boundary is 0
  for (int i = 1; i <= m; ++i) {
    const int32_t* srow = mat + static_cast<size_t>(q[i - 1]) * 26;
    int32_t left = free_left ? 0 : -(go + (i - 1) * ge);
    int32_t diag = H[0];
    H[0] = left;
    int32_t e = NEG;
    for (int j = 1; j <= n; ++j) {
      int32_t f = std::max(H[j] - go, F[j] - ge);
      F[j] = f;
      int32_t g = std::max(diag + srow[t[j - 1]], f);
      if (local) g = std::max(g, 0);
      e = std::max(H[j - 1] - go, e - ge);
      int32_t h = std::max(g, e);
      diag = H[j];
      H[j] = h;
      if (local && h > best) best = h;
    }
    if (n > 0 && H[n] > last_col_best) last_col_best = H[n];
  }
  // the rolling row ends holding H[m][.], boundaries included
  if (mode == NW) return H[n];
  if (mode == SW) return best;
  // HW: best of the final row; OV: best of final row and last column
  int32_t row_best = NEG;
  for (int j = 0; j <= n; ++j) row_best = std::max(row_best, H[j]);
  if (mode == HW) return row_best;
  return std::max(std::max(row_best, last_col_best), 0);
}

}  // namespace

extern "C" {

// Score-only batch: one query vs n_targets addressed as (base + starts[i],
// lens[i]) — PackedTargets passes its arrays zero-copy, contiguous callers
// pass starts=offsets[:-1], lens=diff(offsets).  Linear memory per thread.
void sift4g_score_batch(const uint8_t* q, int32_t qlen, const uint8_t* base,
                        const int64_t* starts, const int32_t* lens,
                        int32_t n_targets, const int32_t* matrix26,
                        int32_t gap_open, int32_t gap_extend, int32_t mode,
                        int32_t n_threads, int32_t* out_score) {
  unsigned hw = std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : (hw ? static_cast<int>(hw) : 4);
  nt = std::min<int>(nt, std::max<int32_t>(1, n_targets));
  // striped SIMD path (SW only): one shared read-only query profile, a
  // per-target int16 overflow guard (max attainable score is bounded by
  // min(m, n) * max|sub|), scalar fallback everywhere else
  int32_t matmax = 0;
  for (int x = 0; x < 26 * 26; ++x)
    matmax = std::max(matmax, std::abs(matrix26[x]));
  const bool striped_ok =
      mode == SW && qlen > 0 && sift4g_simd::have_avx2() &&
      gap_open < 30000 && gap_extend < 30000 &&
      std::getenv("SIFT4G_TPU_NO_SIMD") == nullptr;  // scalar A/B knob
  sift4g_simd::Profile16 prof;
  if (striped_ok) sift4g_simd::build_profile16(q, qlen, matrix26, &prof);
  std::atomic<int32_t> next{0};
  auto worker = [&]() {
    std::vector<int32_t> hbuf, fbuf;
    sift4g_simd::Striped16Buffers sbuf;
    for (;;) {
      int32_t idx = next.fetch_add(1);
      if (idx >= n_targets) return;
      const int32_t len = lens[idx];
      if (striped_ok && len > 0 &&
          static_cast<int64_t>(std::min<int32_t>(qlen, len)) * matmax <
              30000) {
        out_score[idx] = sift4g_simd::sw_striped16(
            prof, base + starts[idx], len, gap_open, gap_extend, &sbuf);
      } else {
        out_score[idx] =
            score_one(q, qlen, base + starts[idx], len, matrix26,
                      gap_open, gap_extend, mode, &hbuf, &fbuf);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Align one query against n_targets targets (concatenated codes + offsets).
// Outputs: per-target score/starts/ends; edit paths concatenated into
// moves_buf (caller-sized to sum(m + n_i)) with moves_off (n_targets + 1).
// Returns 0 on success, -1 if moves_buf would overflow.
int sift4g_align_batch(const uint8_t* q, int32_t qlen, const uint8_t* targets,
                       const int64_t* offsets, int32_t n_targets,
                       const int32_t* matrix26 /* 26x26 row-major */,
                       int32_t gap_open, int32_t gap_extend, int32_t mode,
                       int32_t n_threads, int32_t* out_score,
                       int32_t* out_qstart, int32_t* out_qend,
                       int32_t* out_tstart, int32_t* out_tend,
                       uint8_t* moves_buf, int64_t moves_cap,
                       int64_t* moves_off) {
  std::vector<AlignResult> results(n_targets);
  unsigned hw = std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : (hw ? static_cast<int>(hw) : 4);
  nt = std::min<int>(nt, std::max<int32_t>(1, n_targets));

  // striped AVX2 traceback fill (SW only): one shared read-only query
  // profile, per-target int16 overflow guard — same gate as the score
  // path (sift4g_score_batch)
  int32_t matmax = 0;
  for (int x = 0; x < 26 * 26; ++x)
    matmax = std::max(matmax, std::abs(matrix26[x]));
  const bool striped_ok =
      mode == SW && qlen > 0 && sift4g_simd::have_avx2() &&
      gap_open < 30000 && gap_extend < 30000 &&
      std::getenv("SIFT4G_TPU_NO_SIMD") == nullptr;
  sift4g_simd::Profile16 prof;
  if (striped_ok) sift4g_simd::build_profile16(q, qlen, matrix26, &prof);

  std::atomic<int32_t> next{0};
  auto worker = [&]() {
    DpBuffers buf;
    for (;;) {
      int32_t idx = next.fetch_add(1);
      if (idx >= n_targets) return;
      const uint8_t* t = targets + offsets[idx];
      int n = static_cast<int>(offsets[idx + 1] - offsets[idx]);
      if (striped_ok && n > 0 &&
          static_cast<int64_t>(std::min<int32_t>(qlen, n)) * matmax < 30000) {
        align_one_striped(prof, q, qlen, t, n, matrix26, gap_open,
                          gap_extend, &results[idx], &buf);
      } else {
        align_one(q, qlen, t, n, matrix26, gap_open, gap_extend, mode,
                  &results[idx], &buf);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();

  int64_t w = 0;
  for (int32_t i = 0; i < n_targets; ++i) {
    const AlignResult& r = results[i];
    out_score[i] = r.score;
    out_qstart[i] = r.query_start;
    out_qend[i] = r.query_end;
    out_tstart[i] = r.target_start;
    out_tend[i] = r.target_end;
    moves_off[i] = w;
    if (w + static_cast<int64_t>(r.moves.size()) > moves_cap) return -1;
    memcpy(moves_buf + w, r.moves.data(), r.moves.size());
    w += static_cast<int64_t>(r.moves.size());
  }
  moves_off[n_targets] = w;
  return 0;
}

}  // extern "C"
