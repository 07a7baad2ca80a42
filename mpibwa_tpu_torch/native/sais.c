/* Suffix-array construction by induced sorting (SA-IS).
 *
 * Replaces the numpy prefix-doubling constructor (index/build.py:103) for
 * genome-scale references: O(n) time, ~9n bytes working memory with
 * int32 indices (n < 2^31), ~17n with int64 indices for GRCh38-scale
 * doubled sequences (6.2e9 positions). The reference ships no index
 * constructor (pidx.c loads `bwa index` artifacts), so this is our own
 * implementation of the standard SA-IS algorithm (Nong, Zhang & Chan,
 * "Linear Suffix Array Construction by Almost Pure Induced-Sorting") —
 * written from the algorithm, not from any existing code.
 *
 * Convention: the input string s[0..n-1] is over alphabet [0, K); a
 * virtual sentinel s[n] = -1 (smaller than everything) is implied. The
 * output sa[0..n-1] lists the suffixes of s in increasing order (the
 * sentinel suffix itself is NOT included, matching what index/build.py's
 * suffix_array returns).
 *
 * The core lives in sais_core.h and is instantiated twice (32/64-bit
 * indices); the 32-bit form halves memory and is ~1.5x faster, so it
 * serves every genome it can address.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define SAIDX int32_t
#define SAIS_FN(name) name##32
#include "sais_core.h"
#undef SAIDX
#undef SAIS_FN

#define SAIDX int64_t
#define SAIS_FN(name) name##64
#include "sais_core.h"
#undef SAIDX
#undef SAIS_FN

/* public entries: byte alphabet */
int mpibwa_sais_u8(const uint8_t *s, int32_t *sa, int64_t n, int32_t K) {
    if (n < 0 || n > 0x7FFFFFF0L) return -1;
    return sais_core32(s, 1, sa, (int32_t)n, K);
}

int mpibwa_sais64_u8(const uint8_t *s, int64_t *sa, int64_t n, int64_t K) {
    if (n < 0) return -1;
    return sais_core64(s, 1, sa, n, K);
}

/* POSIX drand48-family LCG (x' = a*x + c mod 2^48): lrand48()&3 per
 * draw — the N-hole filling RNG of bns_fasta2bntseq (bntseq.c:253,
 * srand48(11)). state holds the 48-bit x, updated in place so draws
 * chain across contigs exactly like repeated lrand48() calls. */
void mpibwa_lrand48_fill(uint64_t *state, int64_t n, uint8_t *out) {
    uint64_t x = *state;
    const uint64_t A = 0x5DEECE66DULL, C = 0xBULL;
    const uint64_t MASK = (1ULL << 48) - 1;
    for (int64_t i = 0; i < n; i++) {
        x = (A * x + C) & MASK;
        out[i] = (uint8_t)((x >> 17) & 3);
    }
    *state = x;
}
