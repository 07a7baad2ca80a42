/* samtools-fixmate-equivalent over SAM text (reference fixmate.c:160-821
 * semantics; see mpibwa_tpu_torch/io/fixmate.py for the field-level notes).
 * Exposed through ctypes; io/fixmate.py falls back to the Python port when
 * this library is unavailable, and both are tested against the same golden.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MD_MIN_QUALITY 15

#define FPAIRED 1
#define FUNMAP 4
#define FMUNMAP 8
#define FREVERSE 16
#define FMREVERSE 32
#define FREAD1 64
#define FREAD2 128
#define FSECONDARY 256
#define FSUPPLEMENTARY 2048

typedef struct {
    const char *name; int name_len;
    int flag;
    int tid;
    long pos;
    int mapq;
    const char *cigar; int cigar_len;
    int mtid;
    long mpos;
    long tlen;
    const char *seq; int seq_len;
    const char *qual; int qual_len;
    const char *aux; int aux_len; /* tags onward incl trailing newline */
    long score, mscore;
    int mmapq;
    const char *mcigar; int mcigar_len;
    int dead;
} Read;

typedef struct { char *p; size_t len, cap; int err; } Buf;

static void buf_grow(Buf *b, size_t need) {
    if (b->len + need + 1 > b->cap) {
        size_t cap = (b->cap ? b->cap * 2 : 4096);
        while (b->len + need + 1 > cap) cap *= 2;
        char *p = realloc(b->p, cap);
        if (!p) { /* OOM: keep old buffer; caller falls back to Python */
            b->err = 1;
            return;
        }
        b->p = p;
        b->cap = cap;
    }
}

static void buf_put(Buf *b, const char *s, size_t n) {
    buf_grow(b, n);
    if (b->err) return;
    memcpy(b->p + b->len, s, n);
    b->len += n;
}

static void buf_str(Buf *b, const char *s) { buf_put(b, s, strlen(s)); }

static void buf_long(Buf *b, long v) {
    char tmp[24];
    int n = snprintf(tmp, sizeof tmp, "%ld", v);
    buf_put(b, tmp, n);
}

static int tid_of(const char *s, int len, const char *const *names, int n) {
    for (int j = 0; j < n; j++)
        if ((int)strlen(names[j]) == len && !memcmp(names[j], s, len))
            return j;
    return -1;
}

/* Python-list negative indexing (names[-1] == last), matching the
 * reference port's behavior on the (never exercised) tid==-1 case. */
static const char *chr_name(int tid, const char *const *names, int n) {
    if (tid < 0) tid += n;
    return names[tid];
}

/* readParsing (fixmate.c:160-299): line includes the trailing newline. */
static int parse_read(const char *line, const char *end, Read *r,
                      const char *const *names, int n_chr) {
    const char *f[12];
    int flen[12];
    int nf = 0;
    const char *p = line;
    while (nf < 11 && p < end) {
        const char *tab = memchr(p, '\t', end - p);
        if (!tab) break;
        f[nf] = p; flen[nf] = (int)(tab - p); nf++;
        p = tab + 1;
    }
    if (nf < 11) return -1;
    f[11] = p; flen[11] = (int)(end - p); /* aux incl newline, may be "\n" */
    memset(r, 0, sizeof *r);
    r->name = f[0]; r->name_len = flen[0];
    r->flag = atoi(f[1]);
    r->tid = (flen[2] == 1 && f[2][0] == '*') ? -1
             : tid_of(f[2], flen[2], names, n_chr);
    r->pos = (flen[3] == 1 && f[3][0] == '*') ? -1 : atol(f[3]);
    r->mapq = atoi(f[4]);
    r->cigar = f[5]; r->cigar_len = flen[5];
    r->mtid = (flen[6] == 1 && f[6][0] == '=') ? r->tid
              : ((flen[6] == 1 && f[6][0] == '*') ? -1
                 : tid_of(f[6], flen[6], names, n_chr));
    r->mpos = (flen[7] == 1 && f[7][0] == '*') ? -1 : atol(f[7]);
    r->tlen = atol(f[8]);
    r->seq = f[9]; r->seq_len = flen[9];
    r->qual = f[10]; r->qual_len = flen[10];
    r->aux = f[11]; r->aux_len = flen[11];
    if (r->aux_len == 0) { r->aux = "\n"; r->aux_len = 1; }
    r->score = 0;
    for (int i = 0; i < r->qual_len; i++) {
        int q = r->qual[i] - 33;
        if (q >= MD_MIN_QUALITY) r->score += q;
    }
    r->mcigar = NULL; r->mcigar_len = 0;
    return 0;
}

static void sync_unmapped_pos(Read *src, Read *dest) {
    if ((dest->flag & FUNMAP) && !(src->flag & FUNMAP)) {
        dest->tid = src->tid;
        dest->pos = src->pos;
    }
}

static void sync_mate_inner(Read *src, Read *dest) {
    dest->mtid = src->tid;
    dest->mpos = src->pos;
    if (src->flag & FREVERSE) dest->flag |= FMREVERSE;
    else dest->flag &= ~FMREVERSE;
    if (src->flag & FUNMAP) dest->flag |= FMUNMAP;
}

static void sync_mq_mc(Read *src, Read *dest) {
    if (!(src->flag & FUNMAP)) {
        dest->mmapq = src->mapq;
        dest->mcigar = src->cigar;
        dest->mcigar_len = src->cigar_len;
    }
}

static void sync_mate(Read *a, Read *b) {
    sync_unmapped_pos(a, b);
    sync_unmapped_pos(b, a);
    sync_mate_inner(a, b);
    sync_mate_inner(b, a);
    sync_mq_mc(a, b);
    sync_mq_mc(b, a);
}

/* shared field prefix: NAME FLAG CHR POS MAPQ CIGAR MCHR MPOS TLEN SEQ QUAL */
static void w_prefix(Buf *o, Read *r, const char *chrn, const char *mchr) {
    buf_put(o, r->name, r->name_len); buf_put(o, "\t", 1);
    buf_long(o, r->flag); buf_put(o, "\t", 1);
    buf_str(o, chrn); buf_put(o, "\t", 1);
    buf_long(o, r->pos); buf_put(o, "\t", 1);
    buf_long(o, r->mapq); buf_put(o, "\t", 1);
    buf_put(o, r->cigar, r->cigar_len); buf_put(o, "\t", 1);
    buf_str(o, mchr); buf_put(o, "\t", 1);
    buf_long(o, r->mpos); buf_put(o, "\t", 1);
    buf_long(o, r->tlen); buf_put(o, "\t", 1);
    buf_put(o, r->seq, r->seq_len); buf_put(o, "\t", 1);
    buf_put(o, r->qual, r->qual_len); buf_put(o, "\t", 1);
}

static void w_ms_aux(Buf *o, Read *r) {
    buf_str(o, "ms:i:"); buf_long(o, r->mscore); buf_put(o, "\t", 1);
    buf_put(o, r->aux, r->aux_len);
}

/* sam_write_unmapped_and_munmapped (fixmate.c:447-496) */
static void w_unmapped_pair(Buf *o, Read *r, const char *const *names, int n) {
    const char *chrn, *mchr;
    if (r->tid == -1 && r->mtid == -1) { chrn = "*"; mchr = "*"; }
    else {
        chrn = chr_name(r->tid, names, n);
        mchr = "*";
        if (r->tid != -1 && r->tid == r->mtid) mchr = "=";
        if (r->mtid != -1) mchr = chr_name(r->mtid, names, n);
    }
    w_prefix(o, r, chrn, mchr);
    w_ms_aux(o, r);
}

/* sam_write_discordant (fixmate.c:406-445) */
static void w_discordant(Buf *o, Read *r, const char *const *names, int n) {
    w_prefix(o, r, chr_name(r->tid, names, n), chr_name(r->mtid, names, n));
    buf_str(o, "MQ:i:"); buf_long(o, r->mmapq); buf_put(o, "\t", 1);
    buf_str(o, "MC:Z:"); buf_put(o, r->mcigar, r->mcigar_len);
    buf_put(o, "\t", 1);
    w_ms_aux(o, r);
}

/* sam_write (fixmate.c:549-598) */
static void w_normal(Buf *o, Read *r, const char *const *names, int n) {
    const char *mchr = (r->tid == r->mtid) ? "="
                       : chr_name(r->mtid, names, n);
    w_prefix(o, r, chr_name(r->tid, names, n), mchr);
    buf_str(o, "MQ:i:"); buf_long(o, r->mmapq); buf_put(o, "\t", 1);
    w_ms_aux(o, r);
}

/* sam_write_mate_unmapped (fixmate.c:497-547) */
static void w_mate_unmapped(Buf *o, Read *r, const char *const *names, int n) {
    const char *mchr = (r->tid == r->mtid) ? "="
                       : chr_name(r->mtid, names, n);
    w_prefix(o, r, chr_name(r->tid, names, n), mchr);
    if (r->flag & FUNMAP) {
        buf_str(o, "MQ:i:"); buf_long(o, r->mmapq); buf_put(o, "\t", 1);
        buf_str(o, "MC:Z:"); buf_put(o, r->mcigar, r->mcigar_len);
        buf_put(o, "\t", 1);
    } else {
        buf_str(o, "MC:Z:*\t");
    }
    w_ms_aux(o, r);
}

/* sam_write_supp_and_secondary (fixmate.c:374-404) */
static void w_supp(Buf *o, Read *r, const char *const *names, int n) {
    /* prefix already ends with a tab; supp keeps the original tag block */
    w_prefix(o, r, chr_name(r->tid, names, n), chr_name(r->mtid, names, n));
    buf_put(o, r->aux, r->aux_len);
}

/* fixmate (fixmate.c:601-821) over one pair's SAM strings. Returns two
 * malloc'd NUL-terminated buffers via out1/out2. */
int mpibwa_fixmate_pair(const char *sam1, int len1, const char *sam2,
                        int len2, const char *const *names, int n_chr,
                        char **out1, int *out1_len,
                        char **out2, int *out2_len) {
    Read reads[256];
    int nreads = 0, n1 = 0;
    const char *texts[2] = {sam1, sam2};
    int lens[2] = {len1, len2};
    for (int t = 0; t < 2; t++) {
        const char *p = texts[t], *end = texts[t] + lens[t];
        while (p < end && nreads < 256) {
            const char *nl = memchr(p, '\n', end - p);
            const char *le = nl ? nl + 1 : end;
            if (parse_read(p, le, &reads[nreads], names, n_chr) != 0)
                return -1;
            nreads++;
            p = le;
        }
        if (p < end) return -1; /* >256 records: caller falls back */
        if (t == 0) n1 = nreads;
    }
    (void)n1;
    Buf o1 = {0}, o2 = {0};
    Read *read1 = NULL, *read2 = NULL;

    /* Pairing state: read1/read2 must both be FRESH before emitting; a
       record carrying both read flags, or the same flag twice in a row,
       is malformed input -> return -1 so the caller falls back to the
       Python fixmate (mirrors the reference's reset-per-pair discipline,
       fixmate.c:694-806). */
#define PAIR_TAKE(r)                                                     \
    do {                                                                 \
        if (((r)->flag & FREAD1) && ((r)->flag & FREAD2)) goto malformed;\
        if ((r)->flag & FREAD1) {                                        \
            if (read1) goto malformed;                                   \
            read1 = (r);                                                 \
        } else if ((r)->flag & FREAD2) {                                 \
            if (read2) goto malformed;                                   \
            read2 = (r);                                                 \
        } else {                                                         \
            goto malformed;                                              \
        }                                                                \
    } while (0)

    /* pass 1: both-unmapped pairs (fixmate.c:694-716) */
    for (int i = 0; i < nreads; i++) {
        Read *r = &reads[i];
        if (!r->dead && (r->flag & FUNMAP) && (r->flag & FMUNMAP)) {
            PAIR_TAKE(r);
            if (read1 && read2) {
                read1->flag |= FPAIRED;
                read2->flag |= FPAIRED;
                read2->mscore = read1->score;
                read1->mscore = read2->score;
                w_unmapped_pair(&o1, read1, names, n_chr);
                w_unmapped_pair(&o2, read2, names, n_chr);
                read1->dead = read2->dead = 1;
                read1 = read2 = NULL;
            }
        }
    }

    /* pass 2: both-mapped primary pairs (fixmate.c:719-767) */
    read1 = read2 = NULL;
    for (int i = 0; i < nreads; i++) {
        Read *r = &reads[i];
        if (!r->dead && (r->flag & FPAIRED) && !(r->flag & FSECONDARY)
                && !(r->flag & FSUPPLEMENTARY) && !(r->flag & FUNMAP)
                && !(r->flag & FMUNMAP)) {
            PAIR_TAKE(r);
            if (read1 && read2) {
                read1->flag |= FPAIRED;
                read2->flag |= FPAIRED;
                int discordant = (read1->tid != read1->mtid)
                                 && (read2->tid != read2->mtid);
                sync_mate(read1, read2);
                read2->mscore = read1->score;
                read1->mscore = read2->score;
                if (discordant) {
                    w_discordant(&o1, read1, names, n_chr);
                    w_discordant(&o2, read2, names, n_chr);
                } else {
                    w_normal(&o1, read1, names, n_chr);
                    w_normal(&o2, read2, names, n_chr);
                }
                read1->dead = read2->dead = 1;
                read1 = read2 = NULL;
            }
        }
    }

    /* pass 3: supplementary/secondary + remaining pairs (fixmate.c:769-806) */
    read1 = read2 = NULL;
    for (int i = 0; i < nreads; i++) {
        Read *r = &reads[i];
        if (!r->dead
                && ((r->flag & FSECONDARY) || (r->flag & FSUPPLEMENTARY))) {
            w_supp((r->flag & FREAD1) ? &o1 : &o2, r, names, n_chr);
            r->dead = 1;
            continue;
        }
        if (!r->dead && (r->flag & FPAIRED)) {
            PAIR_TAKE(r);
            if (read1 && read2) {
                read1->flag |= FPAIRED;
                read2->flag |= FPAIRED;
                sync_mate(read1, read2);
                read2->mscore = read1->score;
                read1->mscore = read2->score;
                w_mate_unmapped(&o1, read1, names, n_chr);
                w_mate_unmapped(&o2, read2, names, n_chr);
                read1->dead = read2->dead = 1;
                read1 = read2 = NULL;
            }
        }
    }
#undef PAIR_TAKE

    buf_grow(&o1, 1); buf_grow(&o2, 1);
    if (o1.err || o2.err || !o1.p || !o2.p) goto malformed;
    o1.p[o1.len] = 0;
    o2.p[o2.len] = 0;
    *out1 = o1.p; *out1_len = (int)o1.len;
    *out2 = o2.p; *out2_len = (int)o2.len;
    return 0;

malformed:
    free(o1.p);
    free(o2.p);
    return -1;
}

void mpibwa_buf_free(char *p) { free(p); }
