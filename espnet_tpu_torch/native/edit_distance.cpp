// Copy of espnet_tpu/native/edit_distance.cpp (the port builds its own copy).
// Levenshtein alignment with hit/substitution/deletion/insertion counts.
//
// TPU-native replacement for the reference's SCTK/sclite scorer
// (tools/Makefile:80-83; invoked from egs/mini_an4/asr1/run.sh:307) and the
// editdistance package used by ErrorCalculator
// (espnet/nets/e2e_asr_common.py:100). Token sequences are pre-mapped to
// int32 ids on the Python side; the batch API releases the GIL-free ctypes
// path and scores a whole decode in one call.
//
// Build: g++ -O3 -shared -fPIC -o libeditdist.so edit_distance.cpp

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// counts: [hits, subs, dels, ins] written per pair.
void edit_distance_counts(const int32_t* ref, int32_t ref_len,
                          const int32_t* hyp, int32_t hyp_len,
                          int32_t* counts) {
  const int n = ref_len, m = hyp_len;
  // cost plus packed (h,s,d,i) per cell; rolling rows.
  struct Cell { int32_t c, h, s, d, i; };
  std::vector<Cell> prev(m + 1), cur(m + 1);
  for (int j = 0; j <= m; ++j) prev[j] = {j, 0, 0, 0, j};
  for (int i = 1; i <= n; ++i) {
    cur[0] = {i, 0, 0, i, 0};
    for (int j = 1; j <= m; ++j) {
      Cell best;
      if (ref[i - 1] == hyp[j - 1]) {
        best = prev[j - 1];
        best.h += 1;
      } else {
        best = prev[j - 1];
        best.c += 1;
        best.s += 1;
      }
      Cell del = prev[j];
      del.c += 1;
      del.d += 1;
      if (del.c < best.c) best = del;
      Cell ins = cur[j - 1];
      ins.c += 1;
      ins.i += 1;
      if (ins.c < best.c) best = ins;
      cur[j] = best;
    }
    std::swap(prev, cur);
  }
  counts[0] = prev[m].h;
  counts[1] = prev[m].s;
  counts[2] = prev[m].d;
  counts[3] = prev[m].i;
}

// Batch: flattened id arrays with offsets; counts (n_pairs, 4).
void edit_distance_batch(const int32_t* refs, const int32_t* ref_offsets,
                         const int32_t* hyps, const int32_t* hyp_offsets,
                         int32_t n_pairs, int32_t* counts) {
  for (int32_t p = 0; p < n_pairs; ++p) {
    edit_distance_counts(refs + ref_offsets[p],
                         ref_offsets[p + 1] - ref_offsets[p],
                         hyps + hyp_offsets[p],
                         hyp_offsets[p + 1] - hyp_offsets[p],
                         counts + 4 * p);
  }
}

}  // extern "C"
