// Native BTC descriptor database: side-quantized triangle hash with
// +-1-cell voting search (the host-side half of the reference's
// STDescManager: data_base_ unordered_map + candidate_selector,
// BTC.h:244, BTC.cpp:1128-1279). The port's copy of the JAX package's
// native/btcdb.cpp, built with g++ by voxelslam_tpu_torch/native.py and
// bound with ctypes; the torch ops extract the descriptors, this store
// adds and searches them.
//
// Semantics mirror voxelslam_tpu_torch/loop/btc.py DescriptorDB's dict
// path (use_native=False) exactly:
//   * key = round(sides / side_quant), packed 3x21 bits
//   * a hit votes only when the occupancy-code similarity
//     2*sum(min(b1,b2)) / (sum b1 + sum b2) >= binary_thr
//   * near-in-time same-session frames are skipped
//     (current_frame - f <= skip_near and f <= current_frame)
//   * candidates sorted by raw vote (pair) count, desc, stable
//   * every pair kept up to max_matches; over the cap the pairs of
//     highest code similarity, in insertion order

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

struct TriRef {
  int32_t frame;
  int32_t tri;
};

struct Frame {
  int64_t n_tri = 0;
  int32_t code_len = 0;             // 3*S floats per triangle
  std::vector<float> codes;         // (n_tri, code_len)
  std::vector<float> code_sum;      // (n_tri,)
};

struct BtcDb {
  double side_quant;
  int32_t code_len;
  std::unordered_map<uint64_t, std::vector<TriRef>> buckets;
  std::unordered_map<int32_t, Frame> frames;
};

inline uint64_t pack_key(int64_t a, int64_t b, int64_t c) {
  const uint64_t off = 1u << 20;
  return ((uint64_t)(a + off) << 42) | ((uint64_t)(b + off) << 21) |
         (uint64_t)(c + off);
}

inline int64_t quant(float v, double q) {
  return (int64_t)std::llround((double)v / q);
}

}  // namespace

extern "C" {

void* vs_btcdb_new(double side_quant, int64_t code_len) {
  auto* db = new BtcDb();
  db->side_quant = side_quant;
  db->code_len = (int32_t)code_len;
  return db;
}

void vs_btcdb_free(void* h) { delete (BtcDb*)h; }

// sides: (n,3) f32; codes: (n, code_len) f32; valid: (n,) u8
void vs_btcdb_add(void* h, int64_t frame_id, int64_t n,
                  const float* sides, const float* codes,
                  const uint8_t* valid) {
  auto* db = (BtcDb*)h;
  Frame& fr = db->frames[(int32_t)frame_id];
  fr.n_tri = n;
  fr.code_len = db->code_len;
  fr.codes.assign(codes, codes + n * db->code_len);
  fr.code_sum.resize(n);
  for (int64_t t = 0; t < n; t++) {
    double s = 0;
    for (int32_t k = 0; k < db->code_len; k++)
      s += codes[t * db->code_len + k];
    fr.code_sum[t] = (float)s;
    if (!valid[t]) continue;
    uint64_t key = pack_key(quant(sides[t * 3 + 0], db->side_quant),
                            quant(sides[t * 3 + 1], db->side_quant),
                            quant(sides[t * 3 + 2], db->side_quant));
    db->buckets[key].push_back(TriRef{(int32_t)frame_id, (int32_t)t});
  }
}

// Search. Outputs (up to max_out candidates):
//   out_frames (max_out) i64, out_votes (max_out) i64,
//   out_nkept (max_out) i64, out_pairs (max_out*max_matches*2) i32
// Returns the number of candidates written.
int64_t vs_btcdb_search(void* h, int64_t n, const float* sides,
                        const float* codes, const uint8_t* valid,
                        int64_t skip_near, int64_t current_frame,
                        double binary_thr, int64_t min_votes,
                        int64_t max_matches, int64_t max_out,
                        int64_t* out_frames, int64_t* out_votes,
                        int64_t* out_nkept, int32_t* out_pairs) {
  auto* db = (BtcDb*)h;
  const int32_t L = db->code_len;
  // per-frame matched (query, target, code-sim) pairs, insertion order
  struct Pair { int32_t q, t; float sim; };
  std::unordered_map<int32_t, std::vector<Pair>> votes;
  std::vector<int32_t> order;  // first-seen frame order (stable sort key)

  std::vector<double> qsum(n);
  for (int64_t t = 0; t < n; t++) {
    double s = 0;
    for (int32_t k = 0; k < L; k++) s += codes[t * L + k];
    qsum[t] = s;
  }

  for (int64_t t = 0; t < n; t++) {
    if (!valid[t]) continue;
    int64_t qa = quant(sides[t * 3 + 0], db->side_quant);
    int64_t qb = quant(sides[t * 3 + 1], db->side_quant);
    int64_t qc = quant(sides[t * 3 + 2], db->side_quant);
    const float* qcode = codes + t * L;
    for (int64_t da = -1; da <= 1; da++)
      for (int64_t dbo = -1; dbo <= 1; dbo++)
        for (int64_t dc = -1; dc <= 1; dc++) {
          auto it = db->buckets.find(pack_key(qa + da, qb + dbo, qc + dc));
          if (it == db->buckets.end()) continue;
          for (const TriRef& ref : it->second) {
            if (current_frame - ref.frame <= skip_near &&
                ref.frame <= current_frame)
              continue;
            const Frame& fr = db->frames[ref.frame];
            const float* tcode = fr.codes.data() + (int64_t)ref.tri * L;
            double inter = 0;
            for (int32_t k = 0; k < L; k++)
              inter += std::min(qcode[k], tcode[k]);
            double tot = qsum[t] + fr.code_sum[ref.tri];
            double sim = 2.0 * inter / std::max(tot, 1e-6);
            if (sim < binary_thr) continue;
            auto& v = votes[ref.frame];
            if (v.empty()) order.push_back(ref.frame);
            v.push_back(Pair{(int32_t)t, ref.tri, (float)sim});
          }
        }
  }

  // sort candidate frames by vote count desc (stable on first-seen
  // order, matching python's sorted() stability over dict order)
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) {
                     return votes[a].size() > votes[b].size();
                   });

  int64_t n_out = 0;
  for (int32_t f : order) {
    if (n_out >= max_out) break;
    auto& v = votes[f];
    if ((int64_t)v.size() < min_votes) continue;
    // ALL pairs up to max_matches: the RANSAC verifier needs the full
    // collision set (a per-query-triangle dedup can drop the one
    // correct pair behind a collision). Over the cap, keep the
    // highest-code-similarity pairs, preserving insertion order —
    // exactly the python implementation's selection.
    std::vector<int32_t> idx(v.size());
    for (size_t k = 0; k < v.size(); k++) idx[k] = (int32_t)k;
    if ((int64_t)v.size() > max_matches) {
      std::stable_sort(idx.begin(), idx.end(), [&](int32_t a, int32_t b) {
        return v[a].sim > v[b].sim;
      });
      idx.resize(max_matches);
      std::sort(idx.begin(), idx.end());
    }
    int64_t kept = 0;
    for (int32_t k : idx) {
      out_pairs[(n_out * max_matches + kept) * 2 + 0] = v[k].q;
      out_pairs[(n_out * max_matches + kept) * 2 + 1] = v[k].t;
      if (++kept >= max_matches) break;
    }
    out_frames[n_out] = f;
    out_votes[n_out] = (int64_t)v.size();
    out_nkept[n_out] = kept;
    n_out++;
  }
  return n_out;
}

}  // extern "C"
