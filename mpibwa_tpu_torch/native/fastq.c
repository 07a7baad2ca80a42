/* FASTQ chunk parser: a chunk's reads in one call, into packed columns
 * (io/fastq.py load_columns; semantics of FastqIndex.load + parse_name,
 * the analog of pread_fastq_chunck + bseq_read, parallel_aux.c:2767).
 *
 * Input: one byte range of whole records, or two (R1 and R2 of the same
 * reads), whose records are then interleaved R1, R2, R1, ... Each record
 * is four lines; one '\r' before a line's end is dropped. The name is the
 * header after its first byte up to the first space, or up to the first
 * tab when the header has no space, with a trailing "/<digit>" stripped;
 * the rest after that separator is the comment, written only when
 * keep_comment is set (has_com marks a read whose header had one). The
 * sequence is written as codes through nt4 (256 entries).
 *
 * Returns 0, or nonzero when the caller must take the per-read loader
 * instead: a header or quality byte above 0x7f (the loader decodes them
 * as UTF-8), a column past its capacity, or a range with too few lines.
 * Holds no global state; ctypes releases the GIL around the call.
 */

#include <stdint.h>
#include <string.h>

typedef struct {
    const uint8_t *buf;
    int64_t len;
    int64_t pos; /* start of the next line; len + 1 once past the last */
} cursor_t;

/* The next line as [*b, *b + *n), '\n' and one '\r' before it dropped,
 * as bytes.split(b"\n") yields it; -1 past the last line. */
static int next_line(cursor_t *c, const uint8_t **b, int64_t *n)
{
    if (c->pos > c->len) return -1;
    const uint8_t *p = c->buf + c->pos;
    int64_t left = c->len - c->pos;
    const uint8_t *nl = left > 0 ? memchr(p, '\n', (size_t)left) : NULL;
    int64_t m = nl ? (int64_t)(nl - p) : left;
    c->pos += nl ? m + 1 : left + 1;
    if (m > 0 && p[m - 1] == '\r') m--;
    *b = p;
    *n = m;
    return 0;
}

static int ascii(const uint8_t *p, int64_t n)
{
    uint8_t acc = 0;
    for (int64_t i = 0; i < n; i++) acc |= p[i];
    return acc < 0x80;
}

static int put(uint8_t *dst, int64_t cap, int64_t *at, const uint8_t *src,
               int64_t n)
{
    if (*at + n > cap) return -1;
    if (n) memcpy(dst + *at, src, (size_t)n);
    *at += n;
    return 0;
}

int mpibwa_fastq_parse(const uint8_t *buf1, int64_t len1,
                       const uint8_t *buf2, int64_t len2, int64_t n,
                       int keep_comment, const uint8_t *nt4,
                       uint8_t *seq, int64_t seq_cap, int64_t *seq_off,
                       uint8_t *qual, int64_t qual_cap, int64_t *qual_off,
                       uint8_t *name, int64_t name_cap, int64_t *name_off,
                       uint8_t *com, int64_t com_cap, int64_t *com_off,
                       uint8_t *has_com)
{
    cursor_t cur[2] = {{buf1, len1, 0}, {buf2, len2, 0}};
    int streams = buf2 ? 2 : 1;
    int64_t s_at = 0, q_at = 0, n_at = 0, c_at = 0;
    seq_off[0] = qual_off[0] = name_off[0] = com_off[0] = 0;
    for (int64_t i = 0; i < n; i++) {
        cursor_t *c = &cur[i % streams];
        const uint8_t *h, *s, *plus, *q;
        int64_t hn, sn, pn, qn;
        if (next_line(c, &h, &hn) || next_line(c, &s, &sn)
            || next_line(c, &plus, &pn) || next_line(c, &q, &qn))
            return 2;
        if (!ascii(h, hn) || !ascii(q, qn)) return 1;
        /* header: drop its first byte ('@'), split the name off */
        const uint8_t *hb = hn ? h + 1 : h;
        int64_t hl = hn ? hn - 1 : 0;
        const uint8_t *sp = memchr(hb, ' ', (size_t)hl);
        if (!sp) sp = memchr(hb, '\t', (size_t)hl);
        int64_t nl = sp ? (int64_t)(sp - hb) : hl;
        int64_t kept = nl;
        if (kept >= 2 && hb[kept - 2] == '/' && hb[kept - 1] >= '0'
            && hb[kept - 1] <= '9')
            kept -= 2;
        if (put(name, name_cap, &n_at, hb, kept)) return 2;
        has_com[i] = 0;
        if (keep_comment && sp) {
            has_com[i] = 1;
            if (put(com, com_cap, &c_at, sp + 1, hl - nl - 1)) return 2;
        }
        if (s_at + sn > seq_cap) return 2;
        for (int64_t k = 0; k < sn; k++) seq[s_at + k] = nt4[s[k]];
        s_at += sn;
        if (put(qual, qual_cap, &q_at, q, qn)) return 2;
        seq_off[i + 1] = s_at;
        qual_off[i + 1] = q_at;
        name_off[i + 1] = n_at;
        com_off[i + 1] = c_at;
    }
    return 0;
}
