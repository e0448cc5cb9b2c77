// Native prefilter hot loop: k-mer hashing + LIS chaining + top-k admission.
//
// C-ABI engine behind sift4g_tpu/prefilter/search.py (ctypes).  Semantics
// mirror the reference's threadSearchDatabase
// (reference sift4g/src/database_search.cpp:185-253) and are kept
// bit-compatible with the NumPy fallback in search.py:
//   * 5-bit rolling k-mer packing (hash.cpp:21-44), adjacent-duplicate
//     skip only (quirk Q5, database_search.cpp:212-214);
//   * CSR inverted index over query k-mers is built in Python
//     (prefilter/kmer.py) and passed in as flat arrays;
//   * per (db seq, query): score = LIS(hit positions) / float(db_len)
//     in float32 (database_search.cpp:228-229);
//   * admission with a monotone floor (quirk Q3); at every chunk boundary
//     the per-query list is truncated to the exact top-k SET under the
//     (score desc, db index asc) total order (the deterministic refinement
//     of the reference's unstable sort, quirk Q4) with floor carry-over
//     across chunks (database_search.cpp:151-153).  Mid-stream lists are
//     UNORDERED; ordering is established once at final collect.
//
// Threading splits each chunk into contiguous sequence ranges like the
// reference's pthread-pool fan-out (database_search.cpp:101-123); each
// thread admits into local lists against a chunk-start floor snapshot, and
// the merge + truncate at chunk end makes the result independent of the
// thread count (argument in prefilter/search.py docstring).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

#if defined(__linux__)
#include <sys/mman.h>
#include <unistd.h>
#ifndef MADV_COLLAPSE
#define MADV_COLLAPSE 25
#endif
#endif

namespace {

struct Candidate {
  float score;
  int64_t id;
};

inline bool cand_less(const Candidate& a, const Candidate& b) {
  if (a.score != b.score) return a.score > b.score;  // score desc
  return a.id < b.id;                                // id asc
}

struct SearchCtx {
  int n_queries;
  int max_candidates;
  int k;
  // CSR hash over query k-mers — borrowed pointers; the Python caller
  // keeps the backing arrays alive for the context's lifetime
  // (prefilter/search.py _search_database_native holds the QueryKmerHash)
  const int32_t* starts;
  // presence bitmap over the k-mer table: ~3.4 MB at k=5 (vs the 108 MB
  // offsets table), so the all-but-miss case of the scan stays in cache —
  // only ~|query k-mers| of the 27M table entries are nonempty
  std::vector<uint64_t> present;
  // hits interleaved as (query, pos) pairs: one cache line per hit instead
  // of two (the reference's Hit layout, hash.hpp:19-29)
  struct Hit {
    int32_t q;
    int32_t pos;
  };
  std::vector<Hit> hits;
  // accumulated per-query candidates: the exact top-k SET so far,
  // <= max_candidates, UNORDERED mid-stream (collect_scored sorts)
  std::vector<std::vector<Candidate>> cands;
  std::vector<float> floors;
  // per query: global list reached max_candidates — from then on floors[q]
  // is the global k-th best, and any candidate with score <= floor is
  // provably outranked by >= maxc retained entries under the (score desc,
  // id asc) total order (chunk ids ascend), so threads can gate admission
  // on it even while their LOCAL per-chunk lists are still empty.  This
  // stops the unconditional first-maxc-per-thread admission flood from
  // chunk 2 onward (a superset-pruning refinement of quirk Q3; the merged
  // top-k is unchanged).
  std::vector<uint8_t> full;
  int n_threads;
  bool flat;  // large-query-count gather layout (flat_threshold())
  // accumulated phase stats across chunks (max over threads per chunk for
  // the cycle counters — threads run concurrently, so the wall-clock cost
  // of a phase is its slowest thread): pack, gather, score cycles, then
  // n_lis, n_lis_hits, n_scored summed
  uint64_t stats[8] = {0, 0, 0, 0, 0, 0, 0, 0};
};

// Hit-position accessors: the small-query path scores contiguous int32
// position slices, the flat path scores runs of (q, pos) pairs in place.
inline int32_t pos_at(const int32_t* p, size_t i) { return p[i]; }
inline int32_t pos_at(const SearchCtx::Hit* p, size_t i) { return p[i].pos; }

// Patience LIS length, strictly increasing (database_search.cpp:255-280),
// over a position slice in db k-mer scan order.
// ``min_needed``: abort (returning the current lower bound) as soon as even
// extending by every remaining element cannot reach it — exact when the
// caller only needs to know whether LIS >= min_needed (admission check),
// because the returned value is then provably < min_needed too.
template <typename P>
int lis_length(const P* xs, size_t n, std::vector<int32_t>& tails,
               int min_needed = 0) {
  tails.clear();
  for (size_t i = 0; i < n; ++i) {
    if (static_cast<int>(tails.size() + (n - i)) < min_needed)
      return static_cast<int>(tails.size());
    const int32_t x = pos_at(xs, i);
    auto it = std::lower_bound(tails.begin(), tails.end(), x);
    if (it == tails.end())
      tails.push_back(x);
    else
      *it = x;
  }
  return static_cast<int>(tails.size());
}

struct ThreadState {
  std::vector<std::vector<Candidate>> cands;   // per query, admitted this chunk
  std::vector<float> floors;                   // local floor copies
  // per-query denial gate = (list full ? floor : -inf): the scan denies a
  // pair iff score <= gate, so the dominant deny path reads ONE 4-byte
  // entry instead of three scattered arrays (floors + cands[q] header +
  // full flag — ~580 KB of random working set at 20k queries vs 80 KB).
  // Rebuilt from (full, floors) each round, refreshed on every admission.
  std::vector<float> gate;
  // small-query-count gather scratch (n_queries <= kFlatHitsThreshold):
  // per-query position vectors + touched list — the tables fit in L2 and
  // per-hit random access is cheap
  std::vector<std::vector<int32_t>> qpos;
  std::vector<int32_t> touched;
  // large-query-count gather scratch: flat (q, pos) pairs in db k-mer scan
  // order, grouped per query by a stable LSD radix sort on q (1-3 byte
  // passes; stability preserves arrival order within a query).  At
  // proteome query counts (20k+) three n_queries-sized tables blow the L2
  // and every hit costs ~2 cache misses; the flat buffer + radix passes
  // are sequential (measured: 230 -> 161 s at 20k q x 2M seqs with a
  // comparison sort, radix cheaper still; the per-seq grouping LOSES at
  // 2k q where the tables fit — hence the threshold)
  std::vector<SearchCtx::Hit> seqhits;
  std::vector<SearchCtx::Hit> seqhits2;
  std::vector<int32_t> tails;                  // LIS scratch
  std::vector<uint32_t> kmers;                 // k-mer scratch
  uint64_t cells = 0;
  // per-phase cycle counters (sift4g_search_stats; ~4 rdtsc per sequence,
  // negligible next to the scan itself)
  uint64_t cyc_pack = 0;    // rolling k-mer pack + dedup
  uint64_t cyc_gather = 0;  // bitmap probe + per-query hit gather
  uint64_t cyc_score = 0;   // LIS + admission + truncation
  uint64_t n_lis = 0;       // LIS invocations (not skipped by pre-check)
  uint64_t n_lis_hits = 0;  // total hit-list elements fed to LIS
  uint64_t n_scored = 0;    // (seq, query) pairs reaching the scoring loop
};

// gather-scratch crossover: below this query count the per-query tables
// (3 x n_queries entries) stay cache-resident and win; above it the flat
// sort path wins (see ThreadState comment).  SIFT4G_TPU_FLAT_THRESHOLD
// overrides (tests force the flat path with 0).
inline int flat_threshold() {
  if (const char* s = std::getenv("SIFT4G_TPU_FLAT_THRESHOLD")) return std::atoi(s);
  return 8192;
}

inline uint64_t now_cycles() {
#if defined(__x86_64__)
  unsigned lo, hi;
  __asm__ __volatile__("rdtsc" : "=a"(lo), "=d"(hi));
  return (static_cast<uint64_t>(hi) << 32) | lo;
#else
  return 0;
#endif
}

// Back the scan's randomly-probed tables (CSR starts ~108 MB at k=5, the
// interleaved hit pairs, the presence bitmap) with 2 MB pages via
// MADV_HUGEPAGE + MADV_COLLAPSE (Linux 6.1+; best-effort, failures leave
// the scan correct).  OFF by default: on a virtualized host the hint was
// a measured net loss at proteome scale (gather cycles fell as the TLB
// model predicts, but score+merge regressed more; guest-huge pages over
// host 4 KiB EPT is the suspected mechanism).  Bare-metal hosts with
// THP=madvise can enable with SIFT4G_TPU_THP=1.
#if defined(__linux__)
inline void thp_hint(const void* p, size_t n) {
  static const bool on = [] {
    const char* s = std::getenv("SIFT4G_TPU_THP");
    return s && s[0] == '1';
  }();
  if (!on || n < (4u << 20)) return;  // < 2 huge pages: nothing to collapse
  const size_t page = static_cast<size_t>(sysconf(_SC_PAGESIZE));
  uintptr_t lo = (reinterpret_cast<uintptr_t>(p) + page - 1) & ~(page - 1);
  uintptr_t hi = (reinterpret_cast<uintptr_t>(p) + n) & ~(page - 1);
  if (hi <= lo) return;
  void* a = reinterpret_cast<void*>(lo);
  madvise(a, hi - lo, MADV_HUGEPAGE);
  madvise(a, hi - lo, MADV_COLLAPSE);
}
#else
inline void thp_hint(const void*, size_t) {}
#endif

void scan_range(const SearchCtx* ctx, const uint8_t* codes,
                const int64_t* offsets, int64_t lo, int64_t hi,
                int64_t start_index, ThreadState* st) {
  const int k = ctx->k;
  const int32_t* starts = ctx->starts;
  const uint8_t* gfull = ctx->full.data();
  const int maxc = ctx->max_candidates;
  const bool flat = ctx->flat;
  const int q_bytes =
      ctx->n_queries <= 256 ? 1 : (ctx->n_queries <= 65536 ? 2 : 3);

  // score one (sequence, query) hit list; pos = positions in db k-mer
  // scan order.  Admission + floor + periodic truncation semantics are
  // identical for both gather layouts.
  auto score_one = [&](int32_t q, const auto* pos, size_t h, float len_f,
                       float score1, int64_t db_index) {
    st->n_scored += 1;
    // deny iff (list full && score <= floor) ⇔ score <= gate, since gate
    // caches (full ? floor : -inf) and every score is > 0 (lis >= 1)
    const float gate = st->gate[q];
    float score;
    if (h == 1) {
      if (score1 <= gate) return;
      score = score1;
    } else if (h == 2) {
      const int lis = 1 + (pos_at(pos, 1) > pos_at(pos, 0) ? 1 : 0);
      score = static_cast<float>(lis) / len_f;
      if (score <= gate) return;
    } else {
      // exact LIS skip: lis <= n_hits, so when the list is full and even
      // n_hits/len cannot beat the admission floor the candidate cannot
      // be admitted — identical candidate sets, no O(h log h) work.  At
      // many-query scale (the human-missense mode) this removes the
      // dominant cost once floors rise.
      if (static_cast<float>(h) / len_f <= gate) return;
      int min_needed = 0;
      if (gate > -std::numeric_limits<float>::infinity()) {
        // smallest integer L with (float)L/len > floor — admission needs
        // LIS >= L, so the LIS can abort once it provably falls short.
        // Derived under the same float division the score uses (the +-1
        // scan absorbs rounding at the boundary).
        int L = static_cast<int>(gate * len_f);
        while (L > 0 && static_cast<float>(L - 1) / len_f > gate) --L;
        while (static_cast<float>(L) / len_f <= gate) ++L;
        min_needed = L;
      }
      st->n_lis += 1;
      st->n_lis_hits += h;
      score = static_cast<float>(lis_length(pos, h, st->tails, min_needed)) / len_f;
      if (score <= gate) return;
    }
    auto& lst = st->cands[q];
    float& floor = st->floors[q];
    lst.push_back({score, db_index});
    if (score < floor) floor = score;
    // periodic local truncation: keep the top max_candidates by
    // (score desc, id asc) via O(n) nth_element, raise the floor to the
    // local k-th best.  Exact: within a thread ids ascend, so any later
    // candidate with score <= floor is outranked by >= maxc retained
    // entries under the total order and cannot reach the merged top-k
    // (the retained SET equals a full sort's; order is restored at final
    // collect).  This bounds list memory and makes the LIS skip fire
    // within the first chunk.
    if (static_cast<int>(lst.size()) >= 2 * maxc) {
      std::nth_element(lst.begin(), lst.begin() + (maxc - 1), lst.end(),
                       cand_less);
      floor = lst[maxc - 1].score;
      lst.resize(maxc);
    }
    // refresh the cached gate to the state the next call must observe
    st->gate[q] =
        (static_cast<int>(lst.size()) >= maxc || gfull[q] != 0)
            ? floor
            : -std::numeric_limits<float>::infinity();
  };

  for (int64_t si = lo; si < hi; ++si) {
    const uint8_t* seq = codes + offsets[si];
    const int64_t n = offsets[si + 1] - offsets[si];
    st->cells += static_cast<uint64_t>(n);
    if (n < k) continue;
    uint64_t t0 = now_cycles();

    // rolling 5-bit pack + adjacent-dup skip
    st->kmers.clear();
    uint32_t km = 0;
    for (int j = 0; j < k; ++j) km = (km << 5) | seq[j];
    st->kmers.push_back(km);
    const uint32_t mask = (k == 5) ? 0x1FFFFFFu : (k == 4 ? 0xFFFFFu : 0x7FFFu);
    for (int64_t j = k; j < n; ++j) {
      km = ((km << 5) | seq[j]) & mask;
      if (km != st->kmers.back()) st->kmers.push_back(km);
      else continue;
    }
    // NOTE: adjacent-dup semantics — a k-mer is skipped only when equal to
    // the previous *emitted* k-mer, which for a rolling window is the same
    // as the previous raw k-mer (dup run collapses to one).

    uint64_t t1 = now_cycles();
    st->cyc_pack += t1 - t0;

    // gather hits per query in db k-mer scan order.  The presence bitmap
    // screens k-mers without touching the 108 MB offsets table; on
    // homolog-dense databases a large fraction of k-mers ARE present, so
    // the probe -> starts -> hits dependent-miss chain is staged in blocks
    // with prefetching between stages (each stage's loads issue before the
    // next stage consumes them).
    st->seqhits.clear();
    st->touched.clear();
    const uint64_t* present = ctx->present.data();
    const SearchCtx::Hit* hits_il = ctx->hits.data();
    const size_t nk = st->kmers.size();
    const size_t kPrefetchDist = 16;
    constexpr size_t kBlock = 64;
    uint32_t live[kBlock];
    for (size_t b0 = 0; b0 < nk; b0 += kBlock) {
      const size_t b1 = std::min(nk, b0 + kBlock);
      // stage 1: probe the bitmap (prefetched ahead), collect present
      // k-mers, and issue their starts[] loads
      size_t nlive = 0;
      for (size_t ki = b0; ki < b1; ++ki) {
        if (ki + kPrefetchDist < nk)
          __builtin_prefetch(&present[st->kmers[ki + kPrefetchDist] >> 6], 0, 1);
        const uint32_t kv = st->kmers[ki];
        if ((present[kv >> 6] >> (kv & 63)) & 1) {
          __builtin_prefetch(&starts[kv], 0, 1);
          live[nlive++] = kv;
        }
      }
      // stage 2: read starts ranges, issue the hit-pair loads
      for (size_t li = 0; li < nlive; ++li) {
        if (li + 4 < nlive) {
          const uint32_t kn = live[li + 4];
          __builtin_prefetch(&hits_il[starts[kn]], 0, 1);
        }
        const uint32_t kv = live[li];
        const int64_t s = starts[kv], e = starts[kv + 1];
        if (flat) {
          st->seqhits.insert(st->seqhits.end(), hits_il + s, hits_il + e);
        } else {
          for (int64_t hh = s; hh < e; ++hh) {
            const int32_t q = hits_il[hh].q;
            if (st->qpos[q].empty()) st->touched.push_back(q);
            st->qpos[q].push_back(hits_il[hh].pos);
          }
        }
      }
    }
    size_t nh = 0;
    if (flat) {
      // group hits per query, preserving arrival order: stable LSD radix
      // sort on q (byte passes; only as many as the query count needs)
      nh = st->seqhits.size();
      st->seqhits2.resize(nh);
      SearchCtx::Hit* a = st->seqhits.data();
      SearchCtx::Hit* b = st->seqhits2.data();
      for (int shift_b = 0; shift_b < q_bytes * 8; shift_b += 8) {
        uint32_t counts[256] = {0};
        for (size_t i = 0; i < nh; ++i)
          ++counts[(static_cast<uint32_t>(a[i].q) >> shift_b) & 0xFF];
        uint32_t sum = 0;
        for (int v = 0; v < 256; ++v) {
          const uint32_t c = counts[v];
          counts[v] = sum;
          sum += c;
        }
        for (size_t i = 0; i < nh; ++i)
          b[counts[(static_cast<uint32_t>(a[i].q) >> shift_b) & 0xFF]++] = a[i];
        std::swap(a, b);
      }
      if (a != st->seqhits.data())
        std::swap(st->seqhits, st->seqhits2);
    }

    uint64_t t2 = now_cycles();
    st->cyc_gather += t2 - t1;

    const float len_f = static_cast<float>(n);
    // measured at missense scale (2000q x 5M): the mean hit-list length is
    // ~1.1 — almost every (seq, query) pair shares exactly one k-mer, so
    // its LIS is known without running the patience loop.  score_one's
    // h <= 2 paths compute the score directly under the SAME float
    // division the general path uses (static_cast<float>(1) == 1.0f),
    // keeping candidate sets bit-identical.
    const float score1 = 1.0f / len_f;
    const int64_t db_index = start_index + si;
    if (flat) {
      const SearchCtx::Hit* hs = st->seqhits.data();
      for (size_t i0 = 0; i0 < nh;) {
        const int32_t q = hs[i0].q;
        size_t i1 = i0 + 1;
        while (i1 < nh && hs[i1].q == q) ++i1;
        score_one(q, hs + i0, i1 - i0, len_f, score1, db_index);
        i0 = i1;
      }
    } else {
      for (int32_t q : st->touched) {
        auto& hits = st->qpos[q];
        score_one(q, hits.data(), hits.size(), len_f, score1, db_index);
        hits.clear();
      }
    }
    st->cyc_score += now_cycles() - t2;
  }
}


// Fan a per-query emit step over hardware threads; out offsets come from
// the per-query counts prefix sum so threads write disjoint ranges.
template <typename Fn>
void for_queries_threaded(SearchCtx* ctx, Fn fn) {
  const int nq = ctx->n_queries;
  std::vector<int64_t> off(nq + 1, 0);
  for (int q = 0; q < nq; ++q)
    off[q + 1] = off[q] + static_cast<int64_t>(ctx->cands[q].size());
  const int nt = std::max(1, std::min(ctx->n_threads, nq));
  if (nt == 1 || nq < 64) {
    for (int q = 0; q < nq; ++q) fn(q, off[q]);
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    const int q0 = static_cast<int>(static_cast<int64_t>(nq) * t / nt);
    const int q1 = static_cast<int>(static_cast<int64_t>(nq) * (t + 1) / nt);
    if (q0 >= q1) continue;
    threads.emplace_back([&, q0, q1]() {
      for (int q = q0; q < q1; ++q) fn(q, off[q]);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

void* sift4g_search_create(int n_queries, int max_candidates, int kmer_len,
                           const int32_t* starts, int64_t n_starts,
                           const int32_t* hit_query, const int32_t* hit_pos,
                           int64_t n_hits, int n_threads) {
  auto* ctx = new SearchCtx();
  ctx->n_queries = n_queries;
  ctx->max_candidates = max_candidates;
  ctx->k = kmer_len;
  ctx->starts = starts;
  const int64_t table = n_starts - 1;
  ctx->present.assign(static_cast<size_t>((table + 63) / 64), 0);
  for (int64_t kv = 0; kv < table; ++kv)
    if (starts[kv + 1] > starts[kv])
      ctx->present[kv >> 6] |= (1ull << (kv & 63));
  ctx->hits.resize(static_cast<size_t>(n_hits));
  for (int64_t h = 0; h < n_hits; ++h)
    ctx->hits[h] = {hit_query[h], hit_pos[h]};
  // TLB relief for the randomly-probed tables (opt-in; no-op when small)
  thp_hint(starts, static_cast<size_t>(n_starts) * sizeof(int32_t));
  thp_hint(ctx->hits.data(), ctx->hits.size() * sizeof(SearchCtx::Hit));
  thp_hint(ctx->present.data(), ctx->present.size() * sizeof(uint64_t));
  ctx->cands.resize(n_queries);
  ctx->floors.assign(n_queries, 1e6f);  // database_search.cpp:86
  // max_candidates <= 0 degenerates to "admit nothing": pre-arm every
  // gate at the 1e6 floor (all real scores are <= 1) so the admission
  // path — and its maxc-sized nth_element — is never reached
  ctx->full.assign(n_queries, max_candidates > 0 ? 0 : 1);
  ctx->flat = n_queries > flat_threshold();
  unsigned hw = std::thread::hardware_concurrency();
  ctx->n_threads = n_threads > 0 ? n_threads : (hw ? static_cast<int>(hw) : 4);
  return ctx;
}

// Process one streamed chunk; returns its residue cell count.
uint64_t sift4g_search_chunk(void* handle, const uint8_t* codes,
                             const int64_t* offsets, int64_t n_seq,
                             int64_t start_index) {
  auto* ctx = static_cast<SearchCtx*>(handle);
  const uint64_t tw0 = now_cycles();
  const int nt = static_cast<int>(
      std::min<int64_t>(ctx->n_threads, std::max<int64_t>(1, n_seq)));
  std::vector<ThreadState> states(nt);
  for (auto& st : states) {
    st.cands.resize(ctx->n_queries);
    if (!ctx->flat) st.qpos.resize(ctx->n_queries);
  }
  const int maxc = ctx->max_candidates;
  const int nq = ctx->n_queries;

  // merge + truncate + floor update (database_search.cpp:131-154).  Only
  // the retained SET and the k-th-best floor matter mid-stream, so an O(n)
  // nth_element replaces the full sort (collect_scored sorts at the end).
  // Queries are independent — fan the merge out over the same threads —
  // and queries no thread touched this round skip entirely.
  // Truncation is LAZY once the gate is armed: between truncations the
  // standing floor stays valid (the top-k only improves, so a bound that
  // excluded a candidate before still excludes it) and dst may hold up to
  // maxc + slack entries mid-round; sift4g_search_counts/collect truncate
  // before reporting.  This turns the per-round O(maxc) nth_element into
  // one every ~slack admissions per query.
  const int slack = maxc / 8 + 64;
  auto merge_range = [&](int q0, int q1) {
    for (int q = q0; q < q1; ++q) {
      bool any_new = false;
      for (auto& st : states)
        if (!st.cands[q].empty()) { any_new = true; break; }
      if (!any_new) continue;
      auto& dst = ctx->cands[q];
      for (auto& st : states) {
        dst.insert(dst.end(), st.cands[q].begin(), st.cands[q].end());
        st.cands[q].clear();
      }
      if (!ctx->full[q]) {
        if (static_cast<int>(dst.size()) >= maxc) {
          // arm the gate precisely: truncate to the top-k, floor = k-th
          if (static_cast<int>(dst.size()) > maxc) {
            std::nth_element(dst.begin(), dst.begin() + (maxc - 1),
                             dst.end(), cand_less);
            dst.resize(maxc);
          }
          float lo = dst[0].score;
          for (const auto& c : dst) lo = std::min(lo, c.score);
          ctx->floors[q] = lo;  // min of exactly maxc entries = k-th best
          ctx->full[q] = 1;
        } else {
          float lo = dst[0].score;
          for (const auto& c : dst) lo = std::min(lo, c.score);
          ctx->floors[q] = lo;
        }
      } else if (static_cast<int>(dst.size()) > maxc + slack) {
        std::nth_element(dst.begin(), dst.begin() + (maxc - 1), dst.end(),
                         cand_less);
        dst.resize(maxc);
        ctx->floors[q] = dst[maxc - 1].score;
      }
    }
  };
  auto merge_all = [&]() {
    const int mt = std::min(nt, std::max(1, nq));
    if (mt <= 1 || nq < 64) {
      merge_range(0, nq);
      return;
    }
    std::vector<std::thread> mthreads;
    for (int t = 0; t < mt; ++t) {
      const int q0 = static_cast<int>(static_cast<int64_t>(nq) * t / mt);
      const int q1 = static_cast<int>(static_cast<int64_t>(nq) * (t + 1) / mt);
      if (q0 < q1) mthreads.emplace_back(merge_range, q0, q1);
    }
    for (auto& th : mthreads) th.join();
  };

  // SUB-chunk rounds: merging every ~64M residues arms the global
  // admission floor early, so the first streamed chunk does not pay a
  // whole chunk of ungated per-thread admission floods (the gate only
  // activates once ctx->full[q] is set by a merge).  Candidate sets are
  // invariant to the round size (chunk-size independence is tested);
  // rounds after the floors stabilize skip untouched queries in the merge.
  const int64_t kSubRes = 64 * 1000 * 1000;
  const int64_t total_res = offsets[n_seq];
  uint64_t cells = 0;
  uint64_t scan_cycles = 0;
  int64_t sub_lo = 0;
  while (sub_lo < n_seq) {
    int64_t sub_hi;
    if (total_res - offsets[sub_lo] <= kSubRes + kSubRes / 2) {
      sub_hi = n_seq;  // absorb a small tail into the last round
    } else {
      sub_hi = std::lower_bound(offsets + sub_lo + 1, offsets + n_seq,
                                offsets[sub_lo] + kSubRes) - offsets;
    }
    const uint64_t ts0 = now_cycles();
    for (auto& st : states) {
      st.floors = ctx->floors;
      st.gate.resize(nq);
      for (int q = 0; q < nq; ++q)
        st.gate[q] = ctx->full[q]
                         ? st.floors[q]
                         : -std::numeric_limits<float>::infinity();
    }
    std::vector<std::thread> threads;
    // residue-balanced contiguous ranges (the reference splits by sequence
    // count, database_search.cpp:101-106; real databases have long-tailed
    // length distributions, so balance on offsets instead — candidate sets
    // are split-independent because per-thread lists merge each round)
    const int64_t sub_res = offsets[sub_hi] - offsets[sub_lo];
    int64_t lo = sub_lo;
    for (int t = 0; t < nt; ++t) {
      int64_t hi;
      if (t == nt - 1) {
        hi = sub_hi;
      } else {
        const int64_t target = offsets[sub_lo] + sub_res / nt * (t + 1);
        hi = std::lower_bound(offsets + lo, offsets + sub_hi, target) - offsets;
      }
      if (lo >= hi) continue;
      threads.emplace_back(scan_range, ctx, codes, offsets, lo, hi,
                           start_index, &states[t]);
      lo = hi;
    }
    for (auto& th : threads) th.join();
    scan_cycles += now_cycles() - ts0;
    merge_all();
    sub_lo = sub_hi;
  }

  uint64_t mx[3] = {0, 0, 0};
  for (auto& st : states) {
    cells += st.cells;
    mx[0] = std::max(mx[0], st.cyc_pack);
    mx[1] = std::max(mx[1], st.cyc_gather);
    mx[2] = std::max(mx[2], st.cyc_score);
    ctx->stats[3] += st.n_lis;
    ctx->stats[4] += st.n_lis_hits;
    ctx->stats[5] += st.n_scored;
  }
  for (int i = 0; i < 3; ++i) ctx->stats[i] += mx[i];
  ctx->stats[6] += scan_cycles;
  ctx->stats[7] += (now_cycles() - tw0) - scan_cycles;
  return cells;
}

namespace {

// Lazy merge truncation can leave up to maxc + slack entries per query
// mid-stream; establish the exact top-k SET before anything is reported
// (counts is always called before collect by both consumers, but each
// reporter truncates for safety — the operation is idempotent).
void truncate_all(SearchCtx* ctx) {
  const int maxc = ctx->max_candidates;
  const int nq = ctx->n_queries;
  const int nt = std::max(1, std::min(ctx->n_threads, nq));
  auto trunc = [&](int q0, int q1) {
    for (int q = q0; q < q1; ++q) {
      auto& dst = ctx->cands[q];
      if (static_cast<int>(dst.size()) <= maxc) continue;
      std::nth_element(dst.begin(), dst.begin() + (maxc - 1), dst.end(),
                       cand_less);
      dst.resize(maxc);
      ctx->floors[q] = dst[maxc - 1].score;
    }
  };
  if (nt == 1 || nq < 64) {
    trunc(0, nq);
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    const int q0 = static_cast<int>(static_cast<int64_t>(nq) * t / nt);
    const int q1 = static_cast<int>(static_cast<int64_t>(nq) * (t + 1) / nt);
    if (q0 < q1) threads.emplace_back(trunc, q0, q1);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

void sift4g_search_counts(void* handle, int64_t* out_counts) {
  auto* ctx = static_cast<SearchCtx*>(handle);
  truncate_all(ctx);
  for (int q = 0; q < ctx->n_queries; ++q)
    out_counts[q] = static_cast<int64_t>(ctx->cands[q].size());
}

// Flat per-query candidate db indices, ascending within each query
// (database_search.cpp:173-180).
void sift4g_search_collect(void* handle, int64_t* out_ids) {
  auto* ctx = static_cast<SearchCtx*>(handle);
  truncate_all(ctx);
  for_queries_threaded(ctx, [&](int q, int64_t w) {
    for (auto& c : ctx->cands[q]) out_ids[w++] = c.id;
    std::sort(out_ids + w - static_cast<int64_t>(ctx->cands[q].size()),
              out_ids + w);
  });
}

// Flat per-query (id, score) pairs in (score desc, id asc) order —
// established HERE by sorting each list (chunk merges keep an unordered
// top-k set).  Multi-host runs merge per-shard candidate lists with the
// same total order, so shard merges reproduce the single-process top-k
// exactly.
void sift4g_search_collect_scored(void* handle, int64_t* out_ids,
                                  float* out_scores) {
  auto* ctx = static_cast<SearchCtx*>(handle);
  truncate_all(ctx);
  for_queries_threaded(ctx, [&](int q, int64_t w) {
    // chunk merges keep an unordered top-k set; order is established here
    std::sort(ctx->cands[q].begin(), ctx->cands[q].end(), cand_less);
    for (auto& c : ctx->cands[q]) {
      out_ids[w] = c.id;
      out_scores[w] = c.score;
      ++w;
    }
  });
}

// Phase breakdown for profiling: {pack_cycles, gather_cycles, score_cycles,
// n_lis, n_lis_hits, n_scored, scan_wall_cycles, merge_wall_cycles}.  Cycle values are per-chunk maxima over
// threads, summed over chunks (≈ wall-clock share of each phase).
void sift4g_search_stats(void* handle, uint64_t* out8) {
  auto* ctx = static_cast<SearchCtx*>(handle);
  for (int i = 0; i < 8; ++i) out8[i] = ctx->stats[i];
}

// CSR inverted-index build over ALL query k-mers (hash.cpp:56-85; no
// adjacent-dedup here — that applies to database sequences only, Q5).
// Two calls: count fills starts with the prefix sum and returns n_hits;
// fill writes (query, position) hits in query-scan then position order
// (the reference's fill order).  codes = concatenated query codes,
// offsets = (n_queries+1,) int64 boundaries.
int64_t sift4g_hash_count(const uint8_t* codes, const int64_t* offsets,
                          int64_t n_queries, int k, int32_t* starts,
                          int64_t n_starts) {
  const int64_t table = n_starts - 1;
  std::memset(starts, 0, sizeof(int32_t) * static_cast<size_t>(n_starts));
  const uint32_t mask = (k == 5) ? 0x1FFFFFFu : (k == 4 ? 0xFFFFFu : 0x7FFFu);
  for (int64_t qi = 0; qi < n_queries; ++qi) {
    const uint8_t* seq = codes + offsets[qi];
    const int64_t n = offsets[qi + 1] - offsets[qi];
    if (n < k) continue;
    uint32_t km = 0;
    for (int j = 0; j < k; ++j) km = (km << 5) | seq[j];
    ++starts[km + 1];
    for (int64_t j = k; j < n; ++j) {
      km = ((km << 5) | seq[j]) & mask;
      ++starts[km + 1];
    }
  }
  // inclusive cumsum over counts-at-(km+1): starts[v] becomes the offset
  // of kmer v's first hit, starts[table] the total (the Python layout)
  int64_t sum = 0;
  for (int64_t v = 0; v <= table; ++v) {
    sum += starts[v];
    starts[v] = static_cast<int32_t>(sum);
  }
  return sum;
}

void sift4g_hash_fill(const uint8_t* codes, const int64_t* offsets,
                      int64_t n_queries, int k, const int32_t* starts,
                      int64_t n_starts, int32_t* hit_query,
                      int32_t* hit_pos) {
  const int64_t table = n_starts - 1;
  std::vector<int32_t> cur(starts, starts + table);
  const uint32_t mask = (k == 5) ? 0x1FFFFFFu : (k == 4 ? 0xFFFFFu : 0x7FFFu);
  for (int64_t qi = 0; qi < n_queries; ++qi) {
    const uint8_t* seq = codes + offsets[qi];
    const int64_t n = offsets[qi + 1] - offsets[qi];
    if (n < k) continue;
    uint32_t km = 0;
    for (int j = 0; j < k; ++j) km = (km << 5) | seq[j];
    int32_t w = cur[km]++;
    hit_query[w] = static_cast<int32_t>(qi);
    hit_pos[w] = 0;
    int32_t p = 1;
    for (int64_t j = k; j < n; ++j, ++p) {
      km = ((km << 5) | seq[j]) & mask;
      w = cur[km]++;
      hit_query[w] = static_cast<int32_t>(qi);
      hit_pos[w] = p;
    }
  }
}

void sift4g_search_destroy(void* handle) {
  delete static_cast<SearchCtx*>(handle);
}

}  // extern "C"
