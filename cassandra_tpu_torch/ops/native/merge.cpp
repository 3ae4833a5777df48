// Host merge engine: k-way streaming merge + inline reconcile of sorted
// CellBatch runs — the CompactionIterator formulation
// (db/compaction/CompactionIterator.java:90, utils/MergeIterator.java:23)
// compiled to native code for the host execution path. The numpy
// implementation (storage/cellbatch.py reconcile) is the executable spec;
// randomized tests require bit-identical outputs from numpy, this engine,
// and the TPU kernel.
//
// Inputs: the CONCATENATED batch arrays plus run boundaries. Every run
// must already be sorted by identity lanes asc then ts desc (flush output
// and sstable segments are). Within a cell run (equal identity), the
// winner is selected by the full Cells.resolveRegular comparator, so the
// runs' internal ordering beyond (identity, ts) does not matter. Counter
// batches are handled by the caller (python falls back to the numpy
// path; counters are rare).
//
// Output: indices (into the concatenated arrays) of KEPT cells in merged
// order, plus a per-kept flag marking expired-TTL cells the caller must
// convert to tombstones (AbstractCell.purge path).

#include <cstdint>
#include <cstring>

extern "C" {

// must match storage/cellbatch.py / schema.py
static const uint8_t F_TOMBSTONE = 1;
static const uint8_t F_EXPIRING = 2;
static const uint8_t F_PARTITION_DEL = 4;
static const uint8_t F_ROW_DEL = 8;
static const uint8_t F_COMPLEX_DEL = 32;
static const uint8_t F_DEATH =
    F_TOMBSTONE | F_PARTITION_DEL | F_ROW_DEL | F_COMPLEX_DEL;
static const uint32_t COL_PARTITION_DEL_ID = 0;
static const uint32_t COL_ROW_DEL_ID = 1;
static const int64_t TS_NEG_INF = INT64_MIN;

struct View {
    const uint32_t* lanes;    // [n, K] native-endian
    const int64_t* ts;
    const int32_t* ldt;
    const uint8_t* flags;
    const int64_t* off;       // [n+1]
    const int64_t* val_start; // [n]
    const uint8_t* payload;
    int64_t K;
};

static inline int cmp_lanes(const View& v, int64_t a, int64_t b) {
    const uint32_t* pa = v.lanes + a * v.K;
    const uint32_t* pb = v.lanes + b * v.K;
    for (int64_t k = 0; k < v.K; k++) {
        if (pa[k] != pb[k]) return pa[k] < pb[k] ? -1 : 1;
    }
    return 0;
}

// merge-order comparator between runs: identity lanes asc, ts desc.
// (equality in both -> caller keeps lower run index: stability)
static inline bool stream_less(const View& v, int64_t a, int64_t b) {
    int c = cmp_lanes(v, a, b);
    if (c) return c < 0;
    return v.ts[a] > v.ts[b];
}

// winner ranking within a cell run — Cells.resolveRegular
// (db/rows/Cells.java:79, CASSANDRA-14592): newest ts, then
// expiring-or-tombstone over live, pure tombstone over expiring, larger
// localDeletionTime, larger value bytes, then first-seen. "Pure
// tombstone" is the STATIC isTombstone property (death flag, NO ttl):
// an expired cell converted to a tombstone keeps F_EXPIRING, so its
// rank is identical before and after conversion — clock-independent.
static inline bool beats(const View& v, int64_t a, int64_t b) {
    if (v.ts[a] != v.ts[b]) return v.ts[a] > v.ts[b];
    uint8_t fa = v.flags[a], fb = v.flags[b];
    bool ea = (fa & (F_DEATH | F_EXPIRING)) != 0;
    bool eb = (fb & (F_DEATH | F_EXPIRING)) != 0;
    if (ea != eb) return ea;
    bool da = (fa & F_DEATH) != 0 && (fa & F_EXPIRING) == 0;
    bool db = (fb & F_DEATH) != 0 && (fb & F_EXPIRING) == 0;
    if (da != db) return da;
    if (v.ldt[a] != v.ldt[b]) return v.ldt[a] > v.ldt[b];
    int64_t la = v.off[a + 1] - v.val_start[a];
    int64_t lb = v.off[b + 1] - v.val_start[b];
    int64_t m = la < lb ? la : lb;
    int r = m ? memcmp(v.payload + v.val_start[a],
                       v.payload + v.val_start[b], (size_t)m) : 0;
    if (r) return r > 0;
    if (la != lb) return la > lb;
    return false;                      // full tie: first-seen stays
}

// merge_reconcile: returns number of kept cells (indices written to
// out_idx in merged order; out_expired[i]=1 marks a kept expired-TTL
// cell). run_starts has n_runs+1 entries delimiting the concatenated
// arrays. pts: per-cell max-purgeable timestamp (NULL = +inf), indexed
// like the concatenated arrays. Returns -1 on invalid input.
int64_t merge_reconcile(
    const uint32_t* lanes, const int64_t* ts, const int32_t* ldt,
    const uint8_t* flags, const int64_t* off, const int64_t* val_start,
    const uint8_t* payload, int64_t K, const int64_t* run_starts,
    int64_t n_runs, const int64_t* pts, int64_t gc_before, int64_t now,
    int64_t* out_idx, uint8_t* out_expired) {
    View v{lanes, ts, ldt, flags, off, val_start, payload, K};
    int64_t head[64];
    if (n_runs > 64 || n_runs < 1 || K < 9) return -1;
    for (int64_t r = 0; r < n_runs; r++) head[r] = run_starts[r];

    // reconcile state, carried across the single merged stream. The
    // invariants mirror the numpy scan: rd_ts = max(row deletion, pd),
    // cd_ts = max(complex deletion of this column, rd_ts).
    int64_t pd_ts = TS_NEG_INF;
    int64_t rd_ts = TS_NEG_INF;
    int64_t cd_ts = TS_NEG_INF;
    int64_t cand = -1;                 // current cell run's winner so far
    int64_t n_out = 0;

    const int64_t C = K - 9;
    const int64_t ROW_LANES = 4 + C + 2;  // partition + ck prefix + ckh
    const int64_t COL_LANE = 6 + C;

    // emit the completed cell run's winner: evaluate shadowing/purge with
    // the state of its scopes, then fold deletion markers (winner-only
    // folds — a losing duplicate marker must not shadow anything, exactly
    // like the numpy pd_lead/rd_lead/cd_lead winner masks)
    auto emit = [&](int64_t c) {
        uint32_t col = lanes[c * K + COL_LANE];
        uint8_t fl = flags[c];
        int64_t t = ts[c];
        bool shadowed;
        if (col == COL_PARTITION_DEL_ID) {
            shadowed = false;          // nothing outranks it in-partition
            if (t > pd_ts) {
                pd_ts = t;
                if (rd_ts < t) rd_ts = t;
                if (cd_ts < t) cd_ts = t;
            }
        } else if (col == COL_ROW_DEL_ID) {
            shadowed = t <= pd_ts;
            if (t > rd_ts) {
                rd_ts = t;
                if (cd_ts < t) cd_ts = t;
            }
        } else if (fl & F_COMPLEX_DEL) {
            shadowed = t <= rd_ts;
            if (t > cd_ts) cd_ts = t;
        } else {
            shadowed = t <= cd_ts;
        }
        bool expired = (fl & F_EXPIRING) && ldt[c] <= now;
        bool death = (fl & F_DEATH) != 0 || expired;
        bool purgeable = pts == NULL || t < pts[c];
        bool purged = death && ldt[c] < gc_before && purgeable;
        if (!shadowed && !purged) {
            out_idx[n_out] = c;
            out_expired[n_out] = expired ? 1 : 0;
            n_out++;
        }
    };

    for (;;) {
        int64_t best_run = -1, best = -1;
        for (int64_t r = 0; r < n_runs; r++) {
            if (head[r] >= run_starts[r + 1]) continue;
            if (best_run < 0 || stream_less(v, head[r], best)) {
                best_run = r;
                best = head[r];
            }
        }
        if (best_run < 0) break;
        head[best_run]++;
        int64_t i = best;

        if (cand < 0) {                // very first cell
            cand = i;
            continue;
        }
        const uint32_t* pi = lanes + i * K;
        const uint32_t* pc = lanes + cand * K;
        bool part_new = memcmp(pi, pc, 4 * sizeof(uint32_t)) != 0;
        bool row_new = part_new ||
            memcmp(pi + 4, pc + 4,
                   (size_t)(ROW_LANES - 4) * sizeof(uint32_t)) != 0;
        bool col_new = row_new || pi[COL_LANE] != pc[COL_LANE];
        bool cell_new = col_new ||
            memcmp(pi + COL_LANE + 1, pc + COL_LANE + 1,
                   (size_t)(K - COL_LANE - 1) * sizeof(uint32_t)) != 0;

        if (!cell_new) {               // same cell: compete for winner
            if (beats(v, i, cand)) cand = i;
            continue;
        }
        emit(cand);
        if (part_new) {
            pd_ts = TS_NEG_INF; rd_ts = TS_NEG_INF; cd_ts = TS_NEG_INF;
        } else if (row_new) {
            rd_ts = pd_ts; cd_ts = pd_ts;
        } else if (col_new) {
            cd_ts = rd_ts;
        }
        cand = i;
    }
    if (cand >= 0) emit(cand);
    return n_out;
}

}  // extern "C"
