// Native index-build core.
//
// The per-posting-list build pipeline (randomized k-means blocking,
// block summarization, u8 quantization, local-vocab dense structures) as a
// single C++ pass over all lists. This is the TPU build's equivalent of the
// reference's Rust engine core + rayon build fan-out (reference:
// src/inverted_index.rs:642-649, src/posting_list.rs:375-451,
// src/utils.rs:153-237): Python/NumPy orchestration costs ~1ms per list,
// which at vocabulary scale (30K+ lists) dominates the build; this core
// runs the same per-list work in microseconds and threads across lists.
//
// Exposed via a C ABI for ctypes (no pybind11 in the image).
// Semantics are mirrored by the pure-NumPy implementation in
// seismic_tpu_torch/build/*; an equivalence test pins the two together.
//
// Build: seismic_tpu_torch/native/__init__.py compiles it with g++ into
// seismic_tpu_torch/_build/ at first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

using i32 = int32_t;
using i64 = int64_t;
using u8 = uint8_t;
using u64 = uint64_t;

constexpr i32 kPadComponent = 2147483647;

inline u64 splitmix64(u64 x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

struct Config {
  float centroid_fraction;
  i32 min_cluster_size;
  i32 doc_cut;
  i32 max_block_len;
  float summary_energy;    // used when n_summary_components < 0
  i32 n_summary_components;
  i32 max_summary_nnz;
  i32 v_cap;
  u64 seed;
  i32 fixed_block_size;    // > 0 -> fixed-size blocking
  i32 build_tiles;
  i32 overflow;            // out-of-vocab entries kept per posting
  i32 n_threads;
};

struct Dataset {
  const i64* offsets;
  const i32* comps;
  const float* vals;
  i64 n_docs;
  i64 dim;
};

// Per-list outputs, written into thread-local growable buffers.
struct ListResult {
  std::vector<i32> postings;
  std::vector<i32> posting_block_local;
  std::vector<i32> block_len;           // per block
  std::vector<i32> summary_comps;       // flat, block-major
  std::vector<u8> summary_codes;
  std::vector<i64> summary_len;         // per block
  std::vector<float> summary_min;
  std::vector<float> summary_quant;
  std::vector<i32> vocab;               // <= v_cap, sorted
  std::vector<u8> dense_summary;        // [n_blocks, v_cap]
  std::vector<float> dense_scale;
  std::vector<u8> doc_tiles;            // [list_len, v_cap]
  std::vector<float> doc_tile_scale;
  std::vector<i32> ovf_comps;           // [list_len, overflow]
  std::vector<uint16_t> ovf_vals;       // f16 bits [list_len, overflow]
  // vocab-ladder metadata (mirrors build/builder.py): importance rank of
  // each vocab column (0 = largest summed doc value; 32767 = PAD) and
  // term-mass coverage at the fixed VOCAB_CSUM_GRID widths
  std::vector<int16_t> vocab_rank;      // [v_cap] per list
  std::vector<float> vocab_csum;        // [6] per list
};

static const i64 kVocabCsumGrid[6] = {128, 256, 512, 1024, 2048, 4096};

// minimal f32 -> f16 (round-to-nearest-even via f32 bit tricks)
inline uint16_t f32_to_f16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((x >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = x & 0x7FFFFFu;
  if (exp <= 0) return static_cast<uint16_t>(sign);  // flush tiny to 0
  if (exp >= 31) return static_cast<uint16_t>(sign | 0x7C00u);
  uint32_t half = sign | (static_cast<uint32_t>(exp) << 10) | (mant >> 13);
  // round to nearest (ties up, close enough for stored impact scores)
  if (mant & 0x1000u) half += 1;
  return static_cast<uint16_t>(half);
}

struct Shard {
  // concatenated results of one thread's contiguous list range
  std::vector<i32> list_n_blocks;       // per list in range
  std::vector<i32> list_len;
  ListResult all;
};

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

inline void quantize_u8_minquant(const float* v, i64 n, float* out_min,
                                 float* out_quant, u8* codes) {
  // reference: src/utils.rs:68-90 (min + (max-min)/255 uniform quantizer)
  float mn = v[0], mx = v[0];
  for (i64 i = 1; i < n; ++i) {
    mn = std::min(mn, v[i]);
    mx = std::max(mx, v[i]);
  }
  float quant = (mx - mn) / 255.0f;
  *out_min = mn;
  *out_quant = quant;
  if (quant <= 0.0f) {
    *out_quant = 0.0f;
    std::memset(codes, 0, n);
    return;
  }
  for (i64 i = 0; i < n; ++i) {
    float c = (v[i] - mn) / quant;
    c = c < 0 ? 0 : (c > 255 ? 255 : c);
    codes[i] = static_cast<u8>(c + 0.5f);
  }
}

inline float quantize_row_u8(const float* row, i64 n, u8* codes) {
  // zero-preserving per-row quantizer: dequant = code * scale
  float mx = 0.0f;
  for (i64 i = 0; i < n; ++i) mx = std::max(mx, row[i]);
  if (mx <= 0.0f) {
    std::memset(codes, 0, n);
    return 0.0f;
  }
  float scale = mx / 255.0f;
  for (i64 i = 0; i < n; ++i) {
    float c = row[i] / scale;
    c = c < 0 ? 0 : (c > 255 ? 255 : c);
    codes[i] = static_cast<u8>(c + 0.5f);
  }
  return scale;
}

// component-wise max over a set of docs -> sorted (comp, max) pairs;
// optionally also the per-component SUM (used for vocab ranking)
void maxpool_docs(const Dataset& ds, const i64* doc_ids, i64 n,
                  std::vector<std::pair<i32, float>>* out,
                  std::vector<double>* sums = nullptr) {
  out->clear();
  for (i64 i = 0; i < n; ++i) {
    i64 d = doc_ids[i];
    for (i64 j = ds.offsets[d]; j < ds.offsets[d + 1]; ++j) {
      out->emplace_back(ds.comps[j], ds.vals[j]);
    }
  }
  std::sort(out->begin(), out->end(),
            [](const auto& a, const auto& b) {
              return a.first != b.first ? a.first < b.first
                                        : a.second > b.second;
            });
  if (sums) sums->clear();
  // keep first (max) per component; accumulate sums per component
  i64 w = 0;
  for (i64 r = 0; r < static_cast<i64>(out->size()); ++r) {
    if (w == 0 || (*out)[r].first != (*out)[w - 1].first) {
      (*out)[w++] = (*out)[r];
      if (sums) sums->push_back((*out)[r].second);
    } else if (sums) {
      sums->back() += (*out)[r].second;
    }
  }
  out->resize(w);
}

// ---------------------------------------------------------------------------
// per-list build
// ---------------------------------------------------------------------------

void build_one_list(const Dataset& ds, const Config& cfg, i64 list_id,
                    const i64* doc_ids_in, i64 n, Shard* shard,
                    // scratch
                    std::vector<i64>* scratch_docs,
                    std::vector<std::pair<i32, float>>* pool) {
  ListResult& out = shard->all;
  shard->list_len.push_back(static_cast<i32>(n));
  if (n == 0) {
    shard->list_n_blocks.push_back(0);
    for (i32 v = 0; v < cfg.v_cap; ++v) out.vocab.push_back(kPadComponent);
    for (i32 v = 0; v < cfg.v_cap; ++v) out.vocab_rank.push_back(32767);
    for (int gi = 0; gi < 6; ++gi) out.vocab_csum.push_back(0.f);
    return;
  }

  // ---- 1. blocking -------------------------------------------------------
  std::vector<i64>& docs = *scratch_docs;
  docs.assign(doc_ids_in, doc_ids_in + n);
  std::vector<i64> block_offsets;  // includes 0 and n

  if (cfg.fixed_block_size > 0) {
    // reference: posting_list.rs:217-225 (last block absorbs remainder)
    i64 bs = cfg.fixed_block_size;
    i64 nb = std::max<i64>(1, n / bs);
    block_offsets.push_back(0);
    for (i64 b = 1; b < nb; ++b) block_offsets.push_back(b * bs);
    block_offsets.push_back(n);
  } else {
    // randomized k-means (approx inverted-index variant,
    // reference: src/utils.rs:153-237)
    i64 m = std::max<i64>(1, static_cast<i64>(cfg.centroid_fraction * n));
    // deterministic pseudo-random centroid choice: n smallest hashes
    std::vector<std::pair<u64, i64>> hashes(n);
    for (i64 i = 0; i < n; ++i) {
      hashes[i] = {splitmix64(cfg.seed ^ (0x9E3779B97F4A7C15ull *
                                          (u64)(list_id + 1)) ^ (u64)i),
                   i};
    }
    std::nth_element(hashes.begin(), hashes.begin() + m - 1, hashes.end());
    std::vector<i64> cent_pos(m);
    for (i64 i = 0; i < m; ++i) cent_pos[i] = hashes[i].second;
    std::sort(cent_pos.begin(), cent_pos.end());

    // centroid inverted index: sorted (comp, cent_idx, val)
    struct CEntry { i32 comp; i32 cent; float val; };
    std::vector<CEntry> cidx;
    for (i64 c = 0; c < m; ++c) {
      i64 d = docs[cent_pos[c]];
      for (i64 j = ds.offsets[d]; j < ds.offsets[d + 1]; ++j) {
        cidx.push_back({ds.comps[j], static_cast<i32>(c), ds.vals[j]});
      }
    }
    std::sort(cidx.begin(), cidx.end(),
              [](const CEntry& a, const CEntry& b) { return a.comp < b.comp; });

    // assignment: approximate scores through the centroid index over the
    // doc's top doc_cut components
    std::vector<float> scores(m);
    std::vector<i32> assign(n);
    std::vector<std::pair<float, i32>> top_entries;
    auto assign_doc = [&](i64 i, const bool* removed) {
      i64 d = docs[i];
      i64 len = ds.offsets[d + 1] - ds.offsets[d];
      top_entries.clear();
      for (i64 j = ds.offsets[d]; j < ds.offsets[d + 1]; ++j) {
        top_entries.emplace_back(ds.vals[j], ds.comps[j]);
      }
      i64 cut = std::min<i64>(cfg.doc_cut, len);
      std::partial_sort(top_entries.begin(), top_entries.begin() + cut,
                        top_entries.end(),
                        [](const auto& a, const auto& b) {
                          return a.first > b.first;
                        });
      std::fill(scores.begin(), scores.end(), 0.0f);
      for (i64 t = 0; t < cut; ++t) {
        i32 comp = top_entries[t].second;
        float qv = top_entries[t].first;
        auto it = std::lower_bound(
            cidx.begin(), cidx.end(), comp,
            [](const CEntry& e, i32 c) { return e.comp < c; });
        for (; it != cidx.end() && it->comp == comp; ++it) {
          scores[it->cent] += it->val * qv;
        }
      }
      i32 best = 0;
      float best_s = -1e30f;
      bool any = false;
      for (i64 c = 0; c < m; ++c) {
        if (removed && removed[c]) continue;
        if (!any || scores[c] > best_s) {
          best = static_cast<i32>(c);
          best_s = scores[c];
          any = true;
        }
      }
      assign[i] = any ? best : 0;
    };
    for (i64 i = 0; i < n; ++i) assign_doc(i, nullptr);

    // dissolve small clusters and reassign (reference: utils.rs:189-236;
    // mirrors kmeans.py::_dissolve_and_reassign: removed = size <=
    // min_cluster_size including empties; everything removed -> cluster 0)
    std::vector<i64> sizes(m, 0);
    for (i64 i = 0; i < n; ++i) sizes[assign[i]]++;
    std::vector<u8> removed_v(m, 0);
    bool any_removed = false, all_removed = true;
    for (i64 c = 0; c < m; ++c) {
      removed_v[c] = sizes[c] <= cfg.min_cluster_size ? 1 : 0;
      if (!removed_v[c]) all_removed = false;
      any_removed = any_removed || removed_v[c];
    }
    if (all_removed) {
      std::fill(assign.begin(), assign.end(), 0);
    } else if (any_removed) {
      for (i64 i = 0; i < n; ++i) {
        if (removed_v[assign[i]]) {
          assign_doc(i, reinterpret_cast<const bool*>(removed_v.data()));
        }
      }
    }

    // order by (centroid doc id, doc id) -> blocks
    std::vector<std::pair<i64, i64>> pairs(n);  // (centroid_doc_id, doc_id)
    for (i64 i = 0; i < n; ++i) {
      pairs[i] = {docs[cent_pos[assign[i]]], docs[i]};
    }
    std::sort(pairs.begin(), pairs.end());
    block_offsets.push_back(0);
    for (i64 i = 0; i < n; ++i) {
      docs[i] = pairs[i].second;
      if (i > 0 && pairs[i].first != pairs[i - 1].first) {
        block_offsets.push_back(i);
      }
    }
    block_offsets.push_back(n);
    // dedupe possible duplicate 0/n
    block_offsets.erase(
        std::unique(block_offsets.begin(), block_offsets.end()),
        block_offsets.end());
  }

  // ---- split oversized blocks (TPU tile cap) -----------------------------
  std::vector<i64> final_offsets;
  final_offsets.push_back(0);
  for (size_t b = 1; b < block_offsets.size(); ++b) {
    i64 s = block_offsets[b - 1], e = block_offsets[b];
    i64 p = s;
    while (e - p > cfg.max_block_len) {
      p += cfg.max_block_len;
      final_offsets.push_back(p);
    }
    final_offsets.push_back(e);
  }
  final_offsets.erase(
      std::unique(final_offsets.begin(), final_offsets.end()),
      final_offsets.end());
  i64 n_blocks = static_cast<i64>(final_offsets.size()) - 1;
  shard->list_n_blocks.push_back(static_cast<i32>(n_blocks));

  // postings + per-posting block index
  for (i64 i = 0; i < n; ++i) out.postings.push_back(static_cast<i32>(docs[i]));
  for (i64 b = 0; b < n_blocks; ++b) {
    for (i64 i = final_offsets[b]; i < final_offsets[b + 1]; ++i) {
      out.posting_block_local.push_back(static_cast<i32>(b));
    }
    out.block_len.push_back(
        static_cast<i32>(final_offsets[b + 1] - final_offsets[b]));
  }

  // ---- 2. list vocabulary (top v_cap by SUMMED doc value; mirrors the
  // NumPy pipeline: shared/topical components rank first) ------------------
  std::vector<double> comp_sums;
  maxpool_docs(ds, docs.data(), n, pool, &comp_sums);
  std::vector<std::pair<i32, float>>& pooled = *pool;
  std::vector<i32> vocab;
  if (static_cast<i64>(pooled.size()) > cfg.v_cap) {
    std::vector<std::pair<double, i32>> byval(pooled.size());
    for (size_t i = 0; i < pooled.size(); ++i) {
      byval[i] = {comp_sums[i], pooled[i].first};
    }
    std::nth_element(byval.begin(), byval.begin() + cfg.v_cap - 1,
                     byval.end(),
                     [](const auto& a, const auto& b) {
                       return a.first > b.first;
                     });
    vocab.reserve(cfg.v_cap);
    for (i64 i = 0; i < cfg.v_cap; ++i) vocab.push_back(byval[i].second);
    std::sort(vocab.begin(), vocab.end());
  } else {
    vocab.reserve(pooled.size());
    for (auto& cv : pooled) vocab.push_back(cv.first);
  }
  for (auto c : vocab) out.vocab.push_back(c);
  for (i64 v = static_cast<i64>(vocab.size()); v < cfg.v_cap; ++v) {
    out.vocab.push_back(kPadComponent);
  }

  // ---- 2b. ladder metadata: per-column importance rank + coverage ----
  {
    const i64 nv = static_cast<i64>(vocab.size());
    std::vector<std::pair<double, i64>> kept(nv);  // (sum, vocab col)
    for (i64 j = 0; j < nv; ++j) {
      auto it = std::lower_bound(
          pooled.begin(), pooled.end(), vocab[j],
          [](const std::pair<i32, float>& a, i32 c) { return a.first < c; });
      double s = (it != pooled.end() && it->first == vocab[j])
                     ? comp_sums[static_cast<size_t>(it - pooled.begin())]
                     : 0.0;
      kept[j] = {s, j};
    }
    std::sort(kept.begin(), kept.end(),
              [](const auto& a, const auto& b) { return a.first > b.first; });
    std::vector<int16_t> rank(cfg.v_cap, 32767);
    for (i64 r = 0; r < nv; ++r) {
      rank[kept[r].second] = static_cast<int16_t>(r);
    }
    out.vocab_rank.insert(out.vocab_rank.end(), rank.begin(), rank.end());
    std::vector<double> all(comp_sums);
    std::sort(all.begin(), all.end(), std::greater<double>());
    double total = 0;
    for (double s : all) total += s;
    double cum = 0;
    i64 p = 0;
    for (int gi = 0; gi < 6; ++gi) {
      i64 lim = std::min<i64>(kVocabCsumGrid[gi],
                              static_cast<i64>(all.size()));
      for (; p < lim; ++p) cum += all[p];
      out.vocab_csum.push_back(
          total > 0 ? static_cast<float>(cum / total) : 0.f);
    }
  }

  // ---- 3. per-block summaries (max-pool + selection + u8) ----------------
  std::vector<std::pair<i32, float>> bpool;
  std::vector<float> row(cfg.v_cap);
  std::vector<float> sel_vals;
  std::vector<i32> sel_comps;
  for (i64 b = 0; b < n_blocks; ++b) {
    i64 bs = final_offsets[b], be = final_offsets[b + 1];
    maxpool_docs(ds, docs.data() + bs, be - bs, &bpool);
    // selection (reference: posting_list.rs:302-368)
    std::vector<std::pair<float, i32>> byval(bpool.size());
    for (size_t i = 0; i < bpool.size(); ++i) {
      byval[i] = {bpool[i].second, bpool[i].first};
    }
    std::sort(byval.begin(), byval.end(),
              [](const auto& a, const auto& b) { return a.first > b.first; });
    i64 keep;
    if (cfg.n_summary_components >= 0) {
      keep = std::min<i64>(cfg.n_summary_components, byval.size());
    } else {
      double total = 0;
      for (auto& kv : byval) total += kv.first;
      double until = total * cfg.summary_energy;
      double acc = 0;
      keep = 0;
      while (keep < static_cast<i64>(byval.size()) && acc < until) {
        acc += byval[keep].first;
        keep++;
      }
      keep = std::max<i64>(keep, byval.empty() ? 0 : 1);
    }
    keep = std::min<i64>(keep, cfg.max_summary_nnz);
    sel_comps.clear();
    sel_vals.clear();
    std::vector<std::pair<i32, float>> kept(keep);
    for (i64 i = 0; i < keep; ++i) {
      kept[i] = {byval[i].second, byval[i].first};
    }
    std::sort(kept.begin(), kept.end());
    for (auto& cv : kept) {
      sel_comps.push_back(cv.first);
      sel_vals.push_back(cv.second);
    }
    // u8 quantization (min/quant form)
    float mn = 0, quant = 0;
    std::vector<u8> codes(keep);
    if (keep > 0) {
      quantize_u8_minquant(sel_vals.data(), keep, &mn, &quant, codes.data());
    }
    out.summary_len.push_back(keep);
    out.summary_min.push_back(mn);
    out.summary_quant.push_back(quant);
    for (i64 i = 0; i < keep; ++i) {
      out.summary_comps.push_back(sel_comps[i]);
      out.summary_codes.push_back(codes[i]);
    }

    // dense summary row over the list vocab (dequantized values)
    std::fill(row.begin(), row.end(), 0.0f);
    for (i64 i = 0; i < keep; ++i) {
      auto it = std::lower_bound(vocab.begin(), vocab.end(), sel_comps[i]);
      if (it != vocab.end() && *it == sel_comps[i]) {
        float deq = static_cast<float>(codes[i]) * quant + mn;
        row[it - vocab.begin()] = deq;
      }
    }
    std::vector<u8> drow(cfg.v_cap);
    float scale = quantize_row_u8(row.data(), cfg.v_cap, drow.data());
    out.dense_scale.push_back(scale);
    out.dense_summary.insert(out.dense_summary.end(), drow.begin(),
                             drow.end());
  }

  // ---- 4. doc tiles (dense u8 rows over the list vocab) ------------------
  if (cfg.build_tiles) {
    std::vector<u8> drow(cfg.v_cap);
    std::vector<std::pair<float, i32>> missed;
    for (i64 i = 0; i < n; ++i) {
      i64 d = docs[i];
      std::fill(row.begin(), row.end(), 0.0f);
      missed.clear();
      for (i64 j = ds.offsets[d]; j < ds.offsets[d + 1]; ++j) {
        auto it = std::lower_bound(vocab.begin(), vocab.end(), ds.comps[j]);
        if (it != vocab.end() && *it == ds.comps[j]) {
          row[it - vocab.begin()] = ds.vals[j];
        } else if (cfg.overflow > 0) {
          missed.emplace_back(ds.vals[j], ds.comps[j]);
        }
      }
      float scale = quantize_row_u8(row.data(), cfg.v_cap, drow.data());
      out.doc_tile_scale.push_back(scale);
      out.doc_tiles.insert(out.doc_tiles.end(), drow.begin(), drow.end());
      if (cfg.overflow > 0) {
        // top-`overflow` out-of-vocab entries by value
        i64 keep = std::min<i64>(cfg.overflow, missed.size());
        std::partial_sort(missed.begin(), missed.begin() + keep,
                          missed.end(),
                          [](const auto& a, const auto& b) {
                            return a.first > b.first;
                          });
        for (i64 t = 0; t < keep; ++t) {
          out.ovf_comps.push_back(missed[t].second);
          out.ovf_vals.push_back(f32_to_f16(missed[t].first));
        }
        for (i64 t = keep; t < cfg.overflow; ++t) {
          out.ovf_comps.push_back(kPadComponent);
          out.ovf_vals.push_back(0);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// handle + C ABI
// ---------------------------------------------------------------------------

struct BuildHandle {
  std::vector<Shard> shards;
  i64 n_lists = 0;
  i64 total_postings = 0;
  i64 total_blocks = 0;
  i64 total_summary_nnz = 0;
  i32 v_cap = 0;
  i32 build_tiles = 0;
  i32 overflow = 0;
};

}  // namespace

extern "C" {

void* seismic_build(
    const i64* ds_offsets, const i32* ds_comps, const float* ds_vals,
    i64 n_docs, i64 dim,
    const i64* pt_offsets, const i64* pt_docs, i64 n_lists,
    float centroid_fraction, i32 min_cluster_size, i32 doc_cut,
    i32 max_block_len, float summary_energy, i32 n_summary_components,
    i32 max_summary_nnz, i32 v_cap, u64 seed, i32 fixed_block_size,
    i32 build_tiles, i32 overflow, i32 n_threads) {
  Dataset ds{ds_offsets, ds_comps, ds_vals, n_docs, dim};
  Config cfg{centroid_fraction, min_cluster_size, doc_cut, max_block_len,
             summary_energy,    n_summary_components, max_summary_nnz,
             v_cap,             seed,             fixed_block_size,
             build_tiles,       overflow,         n_threads};
  auto* h = new BuildHandle();
  h->n_lists = n_lists;
  h->v_cap = v_cap;
  h->build_tiles = build_tiles;
  h->overflow = overflow;

  i32 nt = n_threads > 0
               ? n_threads
               : static_cast<i32>(
                     std::max(1u, std::thread::hardware_concurrency()));
  nt = static_cast<i32>(std::min<i64>(nt, std::max<i64>(1, n_lists)));
  h->shards.resize(nt);

  auto worker = [&](i32 t) {
    i64 lo = n_lists * t / nt;
    i64 hi = n_lists * (t + 1) / nt;
    Shard& shard = h->shards[t];
    std::vector<i64> scratch_docs;
    std::vector<std::pair<i32, float>> pool;
    for (i64 l = lo; l < hi; ++l) {
      build_one_list(ds, cfg, l, pt_docs + pt_offsets[l],
                     pt_offsets[l + 1] - pt_offsets[l], &shard,
                     &scratch_docs, &pool);
    }
  };
  if (nt == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (i32 t = 0; t < nt; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }

  for (auto& s : h->shards) {
    h->total_postings += static_cast<i64>(s.all.postings.size());
    h->total_blocks += static_cast<i64>(s.all.block_len.size());
    h->total_summary_nnz += static_cast<i64>(s.all.summary_comps.size());
  }
  return h;
}

void seismic_get_sizes(void* handle, i64* total_postings, i64* total_blocks,
                       i64* total_summary_nnz) {
  auto* h = static_cast<BuildHandle*>(handle);
  *total_postings = h->total_postings;
  *total_blocks = h->total_blocks;
  *total_summary_nnz = h->total_summary_nnz;
}

void seismic_copy_out(
    void* handle,
    i32* postings, i32* posting_block_local,
    i32* block_len_out, i32* list_n_blocks, i32* list_len,
    i32* summary_comps, u8* summary_codes, i64* summary_len,
    float* summary_min, float* summary_quant,
    i32* list_vocab, u8* dense_summary, float* dense_scale,
    u8* doc_tiles, float* doc_tile_scale,
    i32* ovf_comps, uint16_t* ovf_vals,
    int16_t* vocab_rank, float* vocab_csum) {
  auto* h = static_cast<BuildHandle*>(handle);
  i64 p = 0, b = 0, s = 0, l = 0;
  for (auto& sh : h->shards) {
    auto& a = sh.all;
    std::memcpy(postings + p, a.postings.data(),
                a.postings.size() * sizeof(i32));
    std::memcpy(posting_block_local + p, a.posting_block_local.data(),
                a.posting_block_local.size() * sizeof(i32));
    if (h->build_tiles) {
      std::memcpy(doc_tiles + p * h->v_cap, a.doc_tiles.data(),
                  a.doc_tiles.size());
      std::memcpy(doc_tile_scale + p, a.doc_tile_scale.data(),
                  a.doc_tile_scale.size() * sizeof(float));
      if (h->overflow > 0) {
        std::memcpy(ovf_comps + p * h->overflow, a.ovf_comps.data(),
                    a.ovf_comps.size() * sizeof(i32));
        std::memcpy(ovf_vals + p * h->overflow, a.ovf_vals.data(),
                    a.ovf_vals.size() * sizeof(uint16_t));
      }
    }
    p += static_cast<i64>(a.postings.size());

    std::memcpy(block_len_out + b, a.block_len.data(),
                a.block_len.size() * sizeof(i32));
    std::memcpy(summary_len + b, a.summary_len.data(),
                a.summary_len.size() * sizeof(i64));
    std::memcpy(summary_min + b, a.summary_min.data(),
                a.summary_min.size() * sizeof(float));
    std::memcpy(summary_quant + b, a.summary_quant.data(),
                a.summary_quant.size() * sizeof(float));
    std::memcpy(dense_summary + b * h->v_cap, a.dense_summary.data(),
                a.dense_summary.size());
    std::memcpy(dense_scale + b, a.dense_scale.data(),
                a.dense_scale.size() * sizeof(float));
    b += static_cast<i64>(a.block_len.size());

    std::memcpy(summary_comps + s, a.summary_comps.data(),
                a.summary_comps.size() * sizeof(i32));
    std::memcpy(summary_codes + s, a.summary_codes.data(),
                a.summary_codes.size());
    s += static_cast<i64>(a.summary_comps.size());

    std::memcpy(list_n_blocks + l, sh.list_n_blocks.data(),
                sh.list_n_blocks.size() * sizeof(i32));
    std::memcpy(list_len + l, sh.list_len.data(),
                sh.list_len.size() * sizeof(i32));
    std::memcpy(list_vocab + l * h->v_cap, a.vocab.data(),
                a.vocab.size() * sizeof(i32));
    if (vocab_rank) {
      std::memcpy(vocab_rank + l * h->v_cap, a.vocab_rank.data(),
                  a.vocab_rank.size() * sizeof(int16_t));
    }
    if (vocab_csum) {
      std::memcpy(vocab_csum + l * 6, a.vocab_csum.data(),
                  a.vocab_csum.size() * sizeof(float));
    }
    l += static_cast<i64>(sh.list_n_blocks.size());
  }
}

void seismic_free(void* handle) { delete static_cast<BuildHandle*>(handle); }

}  // extern "C"
