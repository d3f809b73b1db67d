/* Host fast paths of the input pipeline (the port's copy of
 * tvqaplus_tpu/native/fastops.c).
 *
 * A serve step replays in a few ms on the card while the producer thread
 * collates a headline batch in tens of ms, so these per-example loops are
 * the pipeline's own bound.  A plain C shared library with a C interface,
 * loaded with ctypes (tvqaplus_tpu_torch/native/__init__.py builds it at
 * first use).  Each function computes what the numpy code it replaces
 * computes, bit for bit.
 */
#include <stdint.h>
#include <string.h>

/* Copy n ragged (len_i, dim) float32 arrays into a zero-initialised
 * (n, max_len, dim) batch and write 1.0 into the (n, max_len) mask for the
 * valid rows (mask may be NULL).  Rows beyond max_len are clipped. */
void pad_batch_f32(const float **srcs, const int32_t *lens, int32_t n,
                   int32_t max_len, int32_t dim, float *out, float *mask) {
    for (int32_t i = 0; i < n; ++i) {
        int32_t len = lens[i] < max_len ? lens[i] : max_len;
        memcpy(out + (size_t)i * max_len * dim, srcs[i],
               (size_t)len * dim * sizeof(float));
        if (!mask) continue;
        float *m = mask + (size_t)i * max_len;
        for (int32_t j = 0; j < len; ++j) m[j] = 1.0f;
    }
}

/* The same for a doubly ragged batch: example i holds outer_lens[i] items
 * of (inner_lens[flat], dim) float32 rows, their pointers one after the
 * other in srcs (flat = the running item index), copied into the
 * zero-initialised (n, max_outer, max_inner, dim) batch with 1.0 in the
 * (n, max_outer, max_inner) mask; items past max_outer and rows past
 * max_inner are clipped. */
void pad_batch_2d_f32(const float **srcs, const int32_t *outer_lens,
                      const int32_t *inner_lens, int32_t n,
                      int32_t max_outer, int32_t max_inner, int32_t dim,
                      float *out, float *mask) {
    int32_t flat = 0;
    for (int32_t i = 0; i < n; ++i) {
        int32_t n_inner = outer_lens[i];
        for (int32_t j = 0; j < n_inner; ++j, ++flat) {
            if (j >= max_outer) continue;
            int32_t len = inner_lens[flat];
            if (len > max_inner) len = max_inner;
            size_t base = (size_t)i * max_outer + j;
            memcpy(out + base * max_inner * dim, srcs[flat],
                   (size_t)len * dim * sizeof(float));
            float *m = mask + base * max_inner;
            for (int32_t k = 0; k < len; ++k) m[k] = 1.0f;
        }
    }
}

/* Box IoU with the reference's +1-pixel intersection convention
 * (intersection +1 per side, areas raw): one GT xyxy box against n
 * detected xyxy boxes, in double precision as the python floats are. */
void iou_xyxy_plus1(const double *gt, const double *dets, int32_t n,
                    double *out) {
    double g_area = (gt[2] - gt[0]) * (gt[3] - gt[1]);
    for (int32_t i = 0; i < n; ++i) {
        const double *d = dets + (size_t)i * 4;
        double x1 = gt[0] > d[0] ? gt[0] : d[0];
        double y1 = gt[1] > d[1] ? gt[1] : d[1];
        double x2 = gt[2] < d[2] ? gt[2] : d[2];
        double y2 = gt[3] < d[3] ? gt[3] : d[3];
        double inter = 0.0;
        if (x1 < x2 && y1 < y2) inter = (x2 - x1 + 1.0) * (y2 - y1 + 1.0);
        double d_area = (d[2] - d[0]) * (d[3] - d[1]);
        out[i] = inter / (g_area + d_area - inter);
    }
}

/* Pairwise IoU (n, m) of xyxy boxes for the detection evaluator, with the
 * +1-pixel convention on areas and intersection (boxlist_ops.py:10-48). */
void pairwise_iou_plus1(const double *a, int32_t n, const double *b,
                        int32_t m, double *out) {
    for (int32_t i = 0; i < n; ++i) {
        const double *ba = a + (size_t)i * 4;
        double area_a = (ba[2] - ba[0] + 1.0) * (ba[3] - ba[1] + 1.0);
        for (int32_t j = 0; j < m; ++j) {
            const double *bb = b + (size_t)j * 4;
            double x1 = ba[0] > bb[0] ? ba[0] : bb[0];
            double y1 = ba[1] > bb[1] ? ba[1] : bb[1];
            double x2 = ba[2] < bb[2] ? ba[2] : bb[2];
            double y2 = ba[3] < bb[3] ? ba[3] : bb[3];
            double w = x2 - x1 + 1.0;
            double h = y2 - y1 + 1.0;
            double inter = (w > 0 && h > 0) ? w * h : 0.0;
            double area_b = (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0);
            out[(size_t)i * m + j] = inter / (area_a + area_b - inter);
        }
    }
}

/* Supervised-attention entries (labels.att_entries_from_dense) straight
 * from an example's dense (sli, slw, slr) labels and defined mask, clipped
 * to the spec window (li, lw, lr), into pre-zeroed output rows.  Returns
 * the positive count before the cap (the pipeline's overflow check). */
int32_t att_entries_f32(const float *labels, const float *defined,
                        int32_t sli, int32_t slw, int32_t slr,
                        int32_t li, int32_t lw, int32_t lr, int32_t cap,
                        int32_t *entry_idx, float *entry_valid,
                        float *neg_rows, int32_t *rank, float *group_npos) {
    int32_t wi = sli < li ? sli : li;
    int32_t ww = slw < lw ? slw : lw;
    int32_t wr = slr < lr ? slr : lr;
    int32_t n_pos = 0;
    for (int32_t i = 0; i < wi; ++i) {
        for (int32_t w = 0; w < ww; ++w) {
            const float *lab = labels + ((size_t)i * slw + w) * slr;
            const float *def = defined + ((size_t)i * slw + w) * slr;
            int32_t npos_row = 0;
            for (int32_t r = 0; r < wr; ++r)
                if (lab[r] > 0.0f && def[r] > 0.0f) ++npos_row;
            if (!npos_row) continue;
            int32_t rank_row = 0;
            for (int32_t r = 0; r < wr; ++r) {
                if (!(lab[r] > 0.0f && def[r] > 0.0f)) continue;
                if (n_pos < cap) {
                    int32_t e = n_pos;
                    entry_idx[e] = ((i * lw) + w) * lr + r;
                    entry_valid[e] = 1.0f;
                    rank[e] = rank_row;
                    group_npos[e] = (float)npos_row;
                    float *nrow = neg_rows + (size_t)e * lr;
                    for (int32_t r2 = 0; r2 < wr; ++r2)
                        nrow[r2] = (lab[r2] == 0.0f && def[r2] > 0.0f)
                                       ? 1.0f : 0.0f;
                }
                ++rank_row;
                ++n_pos;
            }
        }
    }
    return n_pos;
}

/* The sub_dedup window indices of one example: per-frame (start, len)
 * token spans -> gather indices into the token stream (+1 for the zero
 * slot; 0 past the window's length or the token capacity n_tok) and the
 * window mask, into pre-zeroed (n, ls) rows.  Returns the tokens past
 * the capacity. */
int32_t fill_sub_windows(const int64_t *spans, int32_t n, int32_t ls,
                         int32_t n_tok, int32_t *win_idx, float *mask) {
    int32_t n_over = 0;
    for (int32_t i = 0; i < n; ++i) {
        int64_t start = spans[2 * i];
        int64_t len = spans[2 * i + 1];
        if (len > ls) len = ls;
        int32_t *wrow = win_idx + (size_t)i * ls;
        float *mrow = mask + (size_t)i * ls;
        for (int64_t p = 0; p < len; ++p) {
            int64_t tok = start + p;
            if (tok < n_tok) {
                wrow[p] = (int32_t)tok + 1;
                mrow[p] = 1.0f;
            } else {
                ++n_over;
            }
        }
    }
    return n_over;
}
