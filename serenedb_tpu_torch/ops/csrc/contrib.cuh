// The per-posting contribution w * sat(tf, dl), shared by bm25.cu (the
// plane kernels bm25_accumulate_rows/_tail and contrib_flat) and pool.cu
// (pool_score). Both libraries build with -fmad=false (ops/_build.py), so
// this one expression gives the same f32 bits per posting on every path:
// the port's form of the reference's "one expression tree" rule
// (serenedb_tpu/ops/bm25.py `contrib_expr`, whose on/off parity between
// the score plane, the ragged path and the posting pool rests on it).

#pragma once

enum { SC_BM25 = 0, SC_TFIDF = 1, SC_LM_DIRICHLET = 2, SC_JM = 3, SC_DFI = 4 };

#define MATCH_EPS 1e-6f

// Per-posting contribution, in the reference's expression order
// (`contrib_of`, serenedb_tpu/ops/bm25.py). `avg` is max(avgdl, 1e-9);
// the LM family carries mu / lambda in the k1 slot and p_t in w.
static __device__ __forceinline__ float contrib(int scorer, float tf,
                                                float dl, float w, float k1,
                                                float b, float avg) {
  switch (scorer) {
    case SC_TFIDF:
      return w * sqrtf(tf);
    case SC_LM_DIRICHLET: {
      float mu = k1;
      float c = log1pf(tf / (mu * w)) + logf(mu / (dl + mu));
      return fmaxf(c, 0.0f) + MATCH_EPS;
    }
    case SC_JM: {
      float lam = k1;
      return log1pf(((1.0f - lam) * tf / fmaxf(dl, 1.0f)) / (lam * w));
    }
    case SC_DFI: {
      float e = w * dl;
      float excess = (tf - e) / sqrtf(fmaxf(e, 1e-9f));
      return (tf > e ? log2f(1.0f + excess) : 0.0f) + MATCH_EPS;
    }
    default: {
      float denom = tf + k1 * (1.0f - b + b * dl / avg);
      return w * (k1 + 1.0f) * tf / fmaxf(denom, 1e-9f);
    }
  }
}
