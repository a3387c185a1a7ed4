/* fastio.c — native fixed-width ASCII table writer.
 *
 * The reference formats every .prf cell with Python "%0.12f"
 * (nsigproclib_no_mpi.py:880-882) inside per-row Python loops
 * (PODFS.py:879-884, 1739-1745, 1794-1800) — the dominant cost when
 * exporting large planes.  This C implementation formats with integer
 * arithmetic (no printf in the hot loop) into heap buffers of about 1 MiB
 * of text; exact same "%0.12f" output, ~40x faster than the Python loop.
 * A large table is cut into parts of rows that several POSIX threads
 * format at once; the parts are written in row order.
 *
 * Built as a shared library at first use (see native/__init__.py) and
 * called through ctypes; no Python.h dependency.
 */

#define _GNU_SOURCE
#include <pthread.h>
#include <sched.h>
#include <stdio.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>
#include <math.h>

#define BUF_CAP (1u << 20)

/* parts a table is cut into, per thread that formats it */
#define PARTS_PER_THREAD 8

/* formatted parts that wait to be written, per thread, at most */
#define PARTS_AHEAD 2

/* Tables of fewer values are formatted on the calling thread alone: below
 * it, starting the threads costs about what they save (PERF.md). */
#define PAR_MIN_VALS (1L << 18)

/* at most as many formatting threads as parse_table takes */
#define MAX_THREADS 16

/* Format v as "%0.12f" into out; returns chars written.
 * Exact printf parity: the scaled integer n = round(v * 10^12) is computed
 * with 128-bit integer arithmetic on the IEEE mantissa (m * 10^12 >> -e,
 * round-half-to-even), which matches printf's exact decimal conversion.
 * Falls back to snprintf for |v| >= ~8.3e6 (where e >= -30 and the shift
 * path narrows) or non-finite values. */
static int fmt_fixed12(double v, char *out)
{
    if (!(v == v) || v > 8.0e6 || v < -8.0e6)
        return snprintf(out, 336, "%0.12f", v);

    char *p = out;
    if (signbit(v)) {
        *p++ = '-';
        v = -v;
    }
    uint64_t bits;
    memcpy(&bits, &v, 8);
    uint64_t mfrac = bits & ((1ull << 52) - 1);
    int expb = (int)((bits >> 52) & 0x7ff);
    uint64_t m;
    int e;
    if (expb == 0) { m = mfrac; e = -1074; }          /* subnormal */
    else { m = mfrac | (1ull << 52); e = expb - 1075; }
    /* v = m * 2^e with e <= -31 for v < 8e6; n = round(m * 10^12 * 2^e) */
    unsigned __int128 n128 = (unsigned __int128)m * 1000000000000ull;
    int s = -e;
    uint64_t n;
    if (m == 0 || s >= 128) {
        n = 0;
    } else {
        unsigned __int128 q = n128 >> s;
        unsigned __int128 rem = n128 - (q << s);
        unsigned __int128 half = (unsigned __int128)1 << (s - 1);
        if (rem > half || (rem == half && (q & 1)))
            q += 1;
        n = (uint64_t)q;
    }
    uint64_t ip = n / 1000000000000ull;
    uint64_t fp = n % 1000000000000ull;

    /* integer part */
    char tmp[24];
    int ti = 0;
    if (ip == 0) {
        *p++ = '0';
    } else {
        while (ip > 0) { tmp[ti++] = (char)('0' + (ip % 10)); ip /= 10; }
        while (ti > 0) *p++ = tmp[--ti];
    }
    *p++ = '.';
    /* 12 fractional digits, zero-padded */
    for (int i = 11; i >= 0; --i) {
        p[i] = (char)('0' + (fp % 10));
        fp /= 10;
    }
    p += 12;
    *p = '\0';
    return (int)(p - out);
}

/* Format row r into buf; returns the bytes written. */
static size_t format_row(const double *data, long r, long ncols, char sep,
                         char *buf)
{
    size_t used = 0;
    for (long c = 0; c < ncols; ++c) {
        if (c) buf[used++] = sep;
        used += (size_t)fmt_fixed12(data[r * ncols + c], buf + used);
    }
    buf[used++] = '\n';
    return used;
}

/* Threads that formatted the calling thread's last table. */
static _Thread_local int last_threads = 1;

/* Threads for a table of nvals values: one below PAR_MIN_VALS, else one
 * less than the processors this process may run on (a processor stays free
 * for the caller's other threads), at most MAX_THREADS.  A cgroup's CPU
 * quota is not seen: the threads then share the quota. */
static int writer_threads(long nvals)
{
    if (nvals < PAR_MIN_VALS) return 1;
    long np = sysconf(_SC_NPROCESSORS_ONLN);
#ifdef __linux__
    cpu_set_t set;
    if (sched_getaffinity(0, sizeof set, &set) == 0) np = CPU_COUNT(&set);
#endif
    long nt = np - 1 < MAX_THREADS ? np - 1 : MAX_THREADS;
    return nt > 1 ? (int)nt : 1;
}

/* One table shared by its threads, cut into parts of part_rows rows.  The
 * threads claim parts in row order and format each into a heap buffer of
 * its own; the calling thread writes the parts in row order, and formats
 * parts itself while the next one to write is not ready.  A part is
 * claimed only while fewer than `ahead` parts wait to be written, so that
 * much text at most is held.  All of it is guarded by mu; a wait blocks. */
struct table {
    const double *data;
    long nrows, ncols, part_rows, nparts, ahead;
    char sep;
    char **text;
    size_t *len;
    char *state;            /* 0 pending, 1 formatted, 2 out of memory */
    long next;              /* the next part to claim */
    long written;           /* the parts written */
    int stop;               /* the table is written, or a write failed */
    pthread_mutex_t mu;
    pthread_cond_t done;    /* a part was formatted */
    pthread_cond_t room;    /* a part was written */
};

/* With mu held: claim the next part, or -1 where none is left or there is
 * no room for one. */
static long claim(struct table *t)
{
    if (t->stop || t->next >= t->nparts || t->next >= t->written + t->ahead)
        return -1;
    return t->next++;
}

/* Format part p with mu released; returns with mu held, the part set. */
static void format_part(struct table *t, long p)
{
    const size_t row_max = (size_t)t->ncols * 340 + 2;
    long r0 = p * t->part_rows;
    long r1 = r0 + t->part_rows < t->nrows ? r0 + t->part_rows : t->nrows;
    /* 17 characters a value as a start; doubled when a row might not fit */
    size_t cap = (size_t)(r1 - r0) * ((size_t)t->ncols * 17 + 1) + row_max;
    size_t used = 0;
    char *buf = (char *)malloc(cap);
    char st = buf ? 1 : 2;
    for (long r = r0; st == 1 && r < r1; ++r) {
        if (used + row_max > cap) {
            char *grown = (char *)realloc(buf, cap *= 2);
            if (grown) buf = grown;
            else st = 2;
        }
        if (st == 1)
            used += format_row(t->data, r, t->ncols, t->sep, buf + used);
    }
    pthread_mutex_lock(&t->mu);
    t->text[p] = buf;
    t->len[p] = used;
    t->state[p] = st;
    pthread_cond_signal(&t->done);
}

static void *format_parts(void *arg)
{
    struct table *t = (struct table *)arg;
    pthread_mutex_lock(&t->mu);
    while (!t->stop && t->next < t->nparts) {
        long p = claim(t);
        if (p < 0) {
            pthread_cond_wait(&t->room, &t->mu);
        } else {
            pthread_mutex_unlock(&t->mu);
            format_part(t, p);
        }
    }
    pthread_mutex_unlock(&t->mu);
    return NULL;
}

/* Format the table on nt threads (the caller one of them) and write it to
 * f in row order; returns the threads that ran, or 0 on an error.  Where a
 * thread cannot be started, the caller does its share. */
static int write_parts(struct table *t, int nt, FILE *f)
{
    pthread_t tid[MAX_THREADS];
    int started = 0, err = 0;
    /* one more than nparts, so that an empty table allocates too */
    t->text = (char **)calloc((size_t)t->nparts + 1, sizeof(char *));
    t->len = (size_t *)calloc((size_t)t->nparts + 1, sizeof(size_t));
    t->state = (char *)calloc((size_t)t->nparts + 1, 1);
    if (!t->text || !t->len || !t->state) {
        free(t->text);
        free(t->len);
        free(t->state);
        return 0;
    }
    pthread_mutex_init(&t->mu, NULL);
    pthread_cond_init(&t->done, NULL);
    pthread_cond_init(&t->room, NULL);
    for (; started < nt - 1; ++started)
        if (pthread_create(&tid[started], NULL, format_parts, t) != 0)
            break;
    pthread_mutex_lock(&t->mu);
    for (long p = 0; p < t->nparts && !err; ++p) {
        while (!t->state[p]) {
            long q = claim(t);
            if (q < 0) pthread_cond_wait(&t->done, &t->mu);
            else {
                pthread_mutex_unlock(&t->mu);
                format_part(t, q);
            }
        }
        pthread_mutex_unlock(&t->mu);
        if (t->state[p] != 1 ||
            fwrite(t->text[p], 1, t->len[p], f) != t->len[p])
            err = 1;
        free(t->text[p]);
        t->text[p] = NULL;
        pthread_mutex_lock(&t->mu);
        t->written = p + 1;
        pthread_cond_signal(&t->room);
    }
    t->stop = 1;
    pthread_cond_broadcast(&t->room);
    pthread_mutex_unlock(&t->mu);
    for (int i = 0; i < started; ++i) pthread_join(tid[i], NULL);
    for (long p = 0; p < t->nparts; ++p) free(t->text[p]);
    pthread_cond_destroy(&t->room);
    pthread_cond_destroy(&t->done);
    pthread_mutex_destroy(&t->mu);
    free(t->text);
    free(t->len);
    free(t->state);
    return err ? 0 : started + 1;
}

/* Write nrows x ncols doubles as sep-joined fixed-12 rows.
 * mode: "w" or "a".  Returns number of rows written, or -1 on error.
 * Reentrant: every call formats into buffers of its own.  A part is
 * about BUF_CAP of text, or less on several threads: an eighth of a
 * thread's rows. */
long write_rows_fixed12(const char *path, const char *mode,
                        const double *data, long nrows, long ncols,
                        char sep)
{
    const int nt = writer_threads(nrows * ncols);
    long part_rows = (long)(BUF_CAP / ((size_t)ncols * 17 + 1));
    long share = (nrows + PARTS_PER_THREAD * nt - 1) / (PARTS_PER_THREAD * nt);
    if (nt > 1 && share < part_rows) part_rows = share;
    if (part_rows < 1) part_rows = 1;
    struct table t = {.data = data, .nrows = nrows, .ncols = ncols,
                      .part_rows = part_rows,
                      .nparts = (nrows + part_rows - 1) / part_rows,
                      .ahead = (long)PARTS_AHEAD * nt, .sep = sep};
    last_threads = 1;

    FILE *f = fopen(path, mode);
    if (!f) return -1;
    int ran = write_parts(&t, nt, f);
    if (fclose(f) != 0) ran = 0;
    if (ran) last_threads = ran;
    return ran ? nrows : -1;
}

/* Threads that formatted the table of the calling thread's last
 * write_rows_fixed12 (1 where the table stayed on one thread). */
int write_rows_fixed12_threads(void)
{
    return last_threads;
}

/* ------------------------------------------------------------------ */
/* Numeric table parser — the framework's data-loader hot path.
 *
 * Reads an ASCII table (whitespace- and/or comma-separated), skipping any
 * line whose first non-space character cannot start a number (headers,
 * comments, the .prf "data,x,y,z,..." role line).  Handles both the
 * inflow.%06i snapshot series (PODFS.py:1230-1240 reads them with
 * np.loadtxt) and .prf profile bodies.  Self-contained (heap file buffer,
 * caller-owned output) so many files can be parsed concurrently — ctypes
 * releases the GIL, and probes.read_inflow_data fans file loads out over a
 * thread pool.
 *
 * out receives up to max_vals doubles; *ncols_out gets the value count of
 * the first numeric line.  Returns total values parsed, -1 on I/O error,
 * -2 if the table holds more than max_vals values.                     */

#ifdef _OPENMP
#include <omp.h>
#endif

/* Correctly-rounded fast double parse (Clinger's fast path: exact when the
 * mantissa fits 53 bits and the decimal exponent is within +/-22, which
 * covers every fixed-12 .prf cell and typical CFD snapshot values); falls
 * back to strtod for long mantissas / large exponents.  Returns the value
 * and advances *pp past the number; sets *ok = 0 if no number present. */
static double parse_double(const char **pp, int *ok)
{
    static const double p10[] = {
        1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11,
        1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};
    const char *start = *pp;
    const char *p = start;
    int neg = 0;
    if (*p == '-') { neg = 1; ++p; }
    else if (*p == '+') ++p;

    uint64_t mant = 0;
    int ndig = 0, dexp = 0, seen = 0, truncated = 0;
    while (*p >= '0' && *p <= '9') {
        if (ndig < 19) { mant = mant * 10 + (uint64_t)(*p - '0'); ++ndig; }
        else { ++dexp; truncated = 1; }
        ++p; ++seen;
    }
    if (*p == '.') {
        ++p;
        while (*p >= '0' && *p <= '9') {
            if (ndig < 19) {
                mant = mant * 10 + (uint64_t)(*p - '0'); ++ndig; --dexp;
            } else truncated = 1;
            ++p; ++seen;
        }
    }
    if (!seen) { *ok = 0; return 0.0; }
    if (*p == 'e' || *p == 'E' || *p == 'd' || *p == 'D') {
        const char *pe = p + 1;
        int eneg = 0;
        if (*pe == '-') { eneg = 1; ++pe; }
        else if (*pe == '+') ++pe;
        int ev = 0, edig = 0;
        while (*pe >= '0' && *pe <= '9' && edig < 8) {
            ev = ev * 10 + (*pe - '0'); ++pe; ++edig;
        }
        if (edig) { dexp += eneg ? -ev : ev; p = pe; }
    }
    *ok = 1;
    if (!truncated && (mant >> 53) == 0 && dexp >= -22 && dexp <= 22) {
        double v = (double)mant;
        v = dexp < 0 ? v / p10[-dexp] : v * p10[dexp];
        *pp = p;
        return neg ? -v : v;
    }
    /* slow exact path */
    char *end;
    double v = strtod(start, &end);
    if (end == start) { *ok = 0; return 0.0; }
    *pp = end;
    return v;
}

/* Parse the half-open text range [p, lim) (which starts at a line start)
 * into out (capacity cap).  Returns the value count, -2 on overflow; first
 * numeric line's value count goes to *ncols_out. */
static long parse_range(const char *p, const char *lim, double *out,
                        long cap, long *ncols_out)
{
    long count = 0, ncols = 0;
    while (p < lim) {
        while (p < lim && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
        if (p >= lim) break;
        int numeric = (*p == '-' || *p == '+' || *p == '.' ||
                       (*p >= '0' && *p <= '9'));
        if (!numeric) {
            while (p < lim && *p != '\n') ++p;
            if (p < lim) ++p;
            continue;
        }
        long line_vals = 0;
        while (p < lim && *p != '\n') {
            if (*p == ' ' || *p == '\t' || *p == '\r' || *p == ',' ||
                *p == ';') { ++p; continue; }
            int ok;
            double v = parse_double(&p, &ok);
            if (!ok) {                  /* junk mid-line: drop the rest */
                while (p < lim && *p != '\n') ++p;
                break;
            }
            if (count >= cap) return -2;
            out[count++] = v;
            ++line_vals;
        }
        if (p < lim) ++p;
        if (ncols == 0) ncols = line_vals;
    }
    *ncols_out = ncols;
    return count;
}

long parse_table(const char *path, double *out, long max_vals,
                 long *ncols_out)
{
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return -1; }
    long size = ftell(f);
    if (size < 0) { fclose(f); return -1; }
    rewind(f);
    char *text = (char *)malloc((size_t)size + 1);
    if (!text) { fclose(f); return -1; }
    if (size && fread(text, 1, (size_t)size, f) != (size_t)size) {
        free(text); fclose(f); return -1;
    }
    fclose(f);
    text[size] = '\0';

    long total;
    long ncols = 0;

#ifdef _OPENMP
    if (size > (1 << 20)) {
        /* chunk at line boundaries; threads parse into private buffers */
        int nt = omp_get_max_threads();
        if (nt > 16) nt = 16;
        const char **starts = (const char **)malloc(
            (size_t)(nt + 1) * sizeof(char *));
        double **bufs = (double **)calloc((size_t)nt, sizeof(double *));
        long *counts = (long *)calloc((size_t)nt, sizeof(long));
        long *cols = (long *)calloc((size_t)nt, sizeof(long));
        if (!starts || !bufs || !counts || !cols) {
            free(starts); free(bufs); free(counts); free(cols);
            free(text);
            return -1;
        }
        starts[0] = text;
        for (int i = 1; i < nt; ++i) {
            const char *p = text + (size * i) / nt;
            while (*p && *p != '\n') ++p;
            starts[i] = *p ? p + 1 : p;
        }
        starts[nt] = text + size;

        int oom = 0;
        #pragma omp parallel for num_threads(nt) schedule(static, 1)
        for (int i = 0; i < nt; ++i) {
            long span = (long)(starts[i + 1] - starts[i]);
            long cap = span / 2 + 1;
            bufs[i] = (double *)malloc((size_t)cap * sizeof(double));
            if (!bufs[i]) {
                #pragma omp atomic write
                oom = 1;
                counts[i] = 0;
            } else {
                counts[i] = parse_range(starts[i], starts[i + 1], bufs[i],
                                        cap, &cols[i]);
            }
        }
        total = 0;
        for (int i = 0; i < nt; ++i) {
            if (counts[i] < 0) total = -2;
            if (total >= 0) total += counts[i];
            if (ncols == 0) ncols = cols[i];
        }
        if (oom) total = -1;
        if (total >= 0) {
            if (total > max_vals) {
                total = -2;
            } else {
                long off = 0;
                for (int i = 0; i < nt; ++i) {
                    memcpy(out + off, bufs[i],
                           (size_t)counts[i] * sizeof(double));
                    off += counts[i];
                }
            }
        }
        for (int i = 0; i < nt; ++i) free(bufs[i]);
        free(starts); free(bufs); free(counts); free(cols);
        free(text);
        if (ncols_out) *ncols_out = ncols;
        return total;
    }
#endif

    total = parse_range(text, text + size, out, max_vals, &ncols);
    free(text);
    if (ncols_out) *ncols_out = ncols;
    return total;
}

/* Plain shortest-float rows (PODFS.dat style "%.17g" round-trippable). */
long write_rows_g17(const char *path, const char *mode,
                    const double *data, long nrows, long ncols,
                    char sep)
{
    FILE *f = fopen(path, mode);
    if (!f) return -1;
    static char buf[BUF_CAP];
    size_t used = 0;
    const size_t row_max = (size_t)ncols * 32 + 2;
    for (long r = 0; r < nrows; ++r) {
        if (used + row_max > BUF_CAP) {
            if (fwrite(buf, 1, used, f) != used) { fclose(f); return -1; }
            used = 0;
        }
        for (long c = 0; c < ncols; ++c) {
            if (c) buf[used++] = sep;
            used += (size_t)snprintf(buf + used, 32, "%.17g",
                                     data[r * ncols + c]);
        }
        buf[used++] = '\n';
    }
    if (used && fwrite(buf, 1, used, f) != used) { fclose(f); return -1; }
    if (fclose(f) != 0) return -1;
    return nrows;
}
