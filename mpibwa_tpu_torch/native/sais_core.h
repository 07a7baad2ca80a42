/* SA-IS core, templated over the index type (included twice by sais.c:
 * SAIDX = int32_t for genomes whose doubled length fits 2^31, SAIDX =
 * int64_t for GRCh38-scale sequences). See sais.c for the algorithm
 * provenance (Nong, Zhang & Chan — written from the paper, not from any
 * existing code; the reference ships no index constructor at all, pidx.c
 * only repackages `bwa index` artifacts).
 *
 * Expects before inclusion:
 *   #define SAIDX   int32_t | int64_t
 *   #define SAIS_FN(name)  name##32 | name##64   (static-symbol mangling)
 */

#define SGET(s, i) (elsize == 1 ? (SAIDX)((const uint8_t *)(s))[i] \
                                : ((const SAIDX *)(s))[i])

/* type array: 1 bit per position, 1 = S-type (suffix smaller than next) */
static inline int SAIS_FN(tget)(const uint8_t *t, SAIDX i) {
    return (t[i >> 3] >> (i & 7)) & 1;
}
static inline void SAIS_FN(tset)(uint8_t *t, SAIDX i, int v) {
    if (v) t[i >> 3] |= (uint8_t)(1u << (i & 7));
    else t[i >> 3] &= (uint8_t)~(1u << (i & 7));
}

static int SAIS_FN(is_lms)(const uint8_t *t, SAIDX i) {
    return i > 0 && SAIS_FN(tget)(t, i) && !SAIS_FN(tget)(t, i - 1);
}

static void SAIS_FN(bucket_sizes)(const void *s, int elsize, SAIDX n,
                                  SAIDX K, SAIDX *C) {
    memset(C, 0, sizeof(SAIDX) * (size_t)K);
    for (SAIDX i = 0; i < n; i++) C[SGET(s, i)]++;
}

static void SAIS_FN(bucket_heads)(const SAIDX *C, SAIDX K, SAIDX *B) {
    SAIDX sum = 0;
    for (SAIDX c = 0; c < K; c++) { B[c] = sum; sum += C[c]; }
}

static void SAIS_FN(bucket_tails)(const SAIDX *C, SAIDX K, SAIDX *B) {
    SAIDX sum = 0;
    for (SAIDX c = 0; c < K; c++) { sum += C[c]; B[c] = sum; }
}

/* induce L-type then S-type suffixes from the placed LMS/S entries.
 * sa holds -1 for empty slots. */
static void SAIS_FN(induce)(const void *s, int elsize, SAIDX n, SAIDX K,
                            const uint8_t *t, SAIDX *sa, SAIDX *C,
                            SAIDX *B) {
    /* L: scan left to right; the sentinel's predecessor s[n-1] first */
    SAIS_FN(bucket_heads)(C, K, B);
    if (n > 0 && !SAIS_FN(tget)(t, n - 1))
        sa[B[SGET(s, n - 1)]++] = n - 1;
    for (SAIDX i = 0; i < n; i++) {
        SAIDX j = sa[i];
        if (j > 0 && !SAIS_FN(tget)(t, j - 1))
            sa[B[SGET(s, j - 1)]++] = j - 1;
    }
    /* S: scan right to left */
    SAIS_FN(bucket_tails)(C, K, B);
    for (SAIDX i = n - 1; i >= 0; i--) {
        SAIDX j = sa[i];
        if (j > 0 && SAIS_FN(tget)(t, j - 1))
            sa[--B[SGET(s, j - 1)]] = j - 1;
    }
}

static int SAIS_FN(sais_core)(const void *s, int elsize, SAIDX *sa, SAIDX n,
                              SAIDX K) {
    if (n == 0) return 0;
    if (n == 1) { sa[0] = 0; return 0; }

    uint8_t *t = calloc(((size_t)n >> 3) + 1, 1);
    SAIDX *C = malloc(sizeof(SAIDX) * (size_t)K);
    SAIDX *B = malloc(sizeof(SAIDX) * (size_t)K);
    if (!t || !C || !B) { free(t); free(C); free(B); return -1; }

    /* classify: position n-1 is L-type (greater than the sentinel) */
    SAIS_FN(tset)(t, n - 1, 0);
    for (SAIDX i = n - 2; i >= 0; i--) {
        SAIDX a = SGET(s, i), b = SGET(s, i + 1);
        SAIS_FN(tset)(t, i, a < b || (a == b && SAIS_FN(tget)(t, i + 1)));
    }

    SAIS_FN(bucket_sizes)(s, elsize, n, K, C);

    /* stage 1: sort LMS substrings by induction */
    for (SAIDX i = 0; i < n; i++) sa[i] = -1;
    SAIS_FN(bucket_tails)(C, K, B);
    for (SAIDX i = 1; i < n; i++)
        if (SAIS_FN(is_lms)(t, i)) sa[--B[SGET(s, i)]] = i;
    SAIS_FN(induce)(s, elsize, n, K, t, sa, C, B);

    /* compact the sorted LMS positions into the front of sa */
    SAIDX nlms = 0;
    for (SAIDX i = 0; i < n; i++)
        if (sa[i] > 0 && SAIS_FN(is_lms)(t, sa[i])) sa[nlms++] = sa[i];

    /* name LMS substrings in sorted order (equal substrings get one name) */
    SAIDX *names = sa + nlms; /* reuse the tail of sa as scratch */
    for (SAIDX i = nlms; i < n; i++) sa[i] = -1;
    SAIDX nname = 0, prev = -1;
    for (SAIDX i = 0; i < nlms; i++) {
        SAIDX pos = sa[i];
        int same = 0;
        if (prev >= 0) {
            /* compare LMS substrings at prev and pos (incl. end symbol) */
            SAIDX a = prev, b = pos;
            same = 1;
            for (SAIDX d = 0;; d++) {
                if (a + d >= n || b + d >= n) { same = 0; break; }
                int la = SAIS_FN(is_lms)(t, a + d);
                int lb = SAIS_FN(is_lms)(t, b + d);
                if (la != lb || SGET(s, a + d) != SGET(s, b + d)) {
                    same = 0;
                    break;
                }
                if (d > 0 && la && lb)
                    break;  /* equal through the closing LMS char */
            }
        }
        if (!same) { nname++; prev = pos; }
        names[pos >> 1] = nname - 1;  /* LMS positions are >= 2 apart */
    }
    /* build the reduced string in LMS position order */
    SAIDX *s1 = malloc(sizeof(SAIDX) * (size_t)(nlms ? nlms : 1));
    if (!s1) { free(t); free(C); free(B); return -1; }
    {
        SAIDX j = 0;
        for (SAIDX i = 0; i < n; i++)
            if (SAIS_FN(is_lms)(t, i)) s1[j++] = names[i >> 1];
    }

    if (nname < nlms) {
        /* recurse on the reduced problem */
        if (SAIS_FN(sais_core)(s1, (int)sizeof(SAIDX), sa, nlms, nname)
                != 0) {
            free(s1); free(t); free(C); free(B);
            return -1;
        }
    } else {
        for (SAIDX i = 0; i < nlms; i++) sa[s1[i]] = i;
    }

    /* map reduced SA back to LMS positions (in text order list) */
    SAIDX *lms = s1; /* reuse */
    {
        SAIDX j = 0;
        for (SAIDX i = 0; i < n; i++)
            if (SAIS_FN(is_lms)(t, i)) lms[j++] = i;
    }
    /* stage 2: place LMS suffixes in their sorted order, then induce */
    SAIDX *order = malloc(sizeof(SAIDX) * (size_t)(nlms ? nlms : 1));
    if (!order) { free(s1); free(t); free(C); free(B); return -1; }
    for (SAIDX i = 0; i < nlms; i++) order[i] = lms[sa[i]];
    for (SAIDX i = 0; i < n; i++) sa[i] = -1;
    SAIS_FN(bucket_tails)(C, K, B);
    for (SAIDX i = nlms - 1; i >= 0; i--) {
        SAIDX pos = order[i];
        sa[--B[SGET(s, pos)]] = pos;
    }
    SAIS_FN(induce)(s, elsize, n, K, t, sa, C, B);

    free(order);
    free(s1);
    free(t);
    free(C);
    free(B);
    return 0;
}

#undef SGET
