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
