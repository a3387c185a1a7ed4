/* podfs_replay.c — standalone C evaluator for PODFS inlet models.
 *
 * The reference framework defines the PODFS replay equation a CFD solver
 * evaluates at its inlet every timestep (docs/usage/CFDCodeIntegration.rst:
 * 85-91) and the on-disk model format (PODFS.dat control file, ibid. 26-37;
 * PODFS_mean.prf / PODFS_mode_%04i.prf field profiles, ibid. 39-54), but
 * ships no solver-side implementation — each solver (PRECISE-UNS, HYDRA,
 * OpenFOAM, CFX; ibid. 96-115) carries its own.  This file is that missing
 * piece: a dependency-free C99 library any C/C++/Fortran solver can link to
 * load a model directory and evaluate
 *
 *   U(x,t) = alpha * U_mean(x)
 *          + sum_i phi_i(x) * Re[ sum_j (Re_ij + i*Im_ij)
 *                                  * exp(2*pi*i * k_ij * t / T) ]
 *
 * at arbitrary times.  Build:
 *
 *   cc -O3 -fopenmp -shared -fPIC podfs_replay.c -o libpodfs_replay.so -lm
 *
 * (OpenMP is optional; it parallelizes batched evaluation over timesteps.)
 * The same library is loaded through ctypes by pods_digital_filter_tpu.native
 * and cross-validated against the JAX Replayer in tests/test_replay.py.
 *
 * API (all functions return 0 / non-NULL on success):
 *
 *   podfs_model *podfs_load(const char *dir);
 *   void         podfs_free(podfs_model *m);
 *   long         podfs_num_points(const podfs_model *m);
 *   long         podfs_num_vars(const podfs_model *m);     // slots per point
 *   long         podfs_num_modes(const podfs_model *m);
 *   double       podfs_period(const podfs_model *m);
 *   const double*podfs_points(const podfs_model *m);       // (Np,3) row-major
 *   int  podfs_eval(const podfs_model *m, double t, double alpha,
 *                   double *out);                          // (Np,nvars)
 *   int  podfs_eval_batch(const podfs_model *m, const double *ts, long nt,
 *                         double alpha, double *out);      // (nt,Np,nvars)
 *
 * nvars is read from the .prf "data," header: 3 (u,v,w) for velocity
 * models, 3 + number of scalars for multi-variable models (the reference's
 * num_vars POD, PODFS.py:1294 / save_Planes packing, PODFS.py:706-734).
 */

#include <ctype.h>
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* Model files use '.' decimals; strtod/strtol are LC_NUMERIC-dependent, and
 * host solvers routinely call setlocale().  On POSIX, parse under a private
 * C locale (uselocale) so loading works regardless of the host's locale;
 * elsewhere the caller must keep LC_NUMERIC="C" (see podfs_replay.h). */
#if !defined(_WIN32)
#define PODFS_HAVE_USELOCALE 1
#include <locale.h>
#endif

#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif

typedef struct podfs_model {
    long np;          /* inlet points */
    long ns;          /* variable slots per point (3 for velocity models;
                         3 + number of scalars for multi-variable models —
                         the reference's num_vars POD, PODFS.py:1294) */
    long nm;          /* POD modes */
    long nc;          /* total Fourier coefficients (sum of counts) */
    double period;
    double *points;   /* np*3 row-major (x,y,z) */
    double *mean;     /* np*ns row-major */
    double *modes;    /* nm * np*ns row-major */
    long *counts;     /* nm */
    long *offsets;    /* nm+1 prefix sum into k/cre/cim */
    double *k;        /* nc wavenumbers */
    double *cre;      /* nc */
    double *cim;      /* nc */
} podfs_model;

/* ---------------------------------------------------------------- file IO */

static char *read_all(const char *path, long *len_out)
{
    FILE *f = fopen(path, "rb");
    char *buf = NULL;
    long len;
    if (!f) return NULL;
    if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return NULL; }
    len = ftell(f);
    if (len < 0 || fseek(f, 0, SEEK_SET) != 0) { fclose(f); return NULL; }
    buf = (char *)malloc((size_t)len + 1);
    if (!buf) { fclose(f); return NULL; }
    if (len && fread(buf, 1, (size_t)len, f) != (size_t)len) {
        free(buf); fclose(f); return NULL;
    }
    fclose(f);
    buf[len] = '\0';
    if (len_out) *len_out = len;
    return buf;
}

/* ------------------------------------------------- PODFS.dat control file */

/* Format (CFDCodeIntegration.rst:26-37, io/prf.py:write_podfs_dat):
 *   num_modes
 *   period
 *   <mode index 1-based> \t <coefficient count>     x num_modes
 *   <k> \t <Re> \t <Im>                             x sum(counts)
 */
static int parse_dat(podfs_model *m, const char *path)
{
    long len = 0;
    char *buf = read_all(path, &len);
    char *p, *end;
    long i;
    if (!buf) return -1;
    p = buf;

    m->nm = strtol(p, &end, 10);
    if (end == p || m->nm < 0) goto fail;
    p = end;
    m->period = strtod(p, &end);
    if (end == p || !(m->period > 0.0)) goto fail;
    p = end;

    m->counts = (long *)calloc((size_t)(m->nm ? m->nm : 1), sizeof(long));
    m->offsets = (long *)calloc((size_t)m->nm + 1, sizeof(long));
    if (!m->counts || !m->offsets) goto fail;
    for (i = 0; i < m->nm; i++) {
        long idx = strtol(p, &end, 10);
        if (end == p || idx != i + 1) goto fail;
        p = end;
        m->counts[i] = strtol(p, &end, 10);
        if (end == p || m->counts[i] < 0) goto fail;
        p = end;
        m->offsets[i + 1] = m->offsets[i] + m->counts[i];
    }
    m->nc = m->offsets[m->nm];
    m->k = (double *)malloc(sizeof(double) * (size_t)(m->nc ? m->nc : 1));
    m->cre = (double *)malloc(sizeof(double) * (size_t)(m->nc ? m->nc : 1));
    m->cim = (double *)malloc(sizeof(double) * (size_t)(m->nc ? m->nc : 1));
    if (!m->k || !m->cre || !m->cim) goto fail;
    for (i = 0; i < m->nc; i++) {
        m->k[i] = strtod(p, &end);
        if (end == p) goto fail;
        p = end;
        m->cre[i] = strtod(p, &end);
        if (end == p) goto fail;
        p = end;
        m->cim[i] = strtod(p, &end);
        if (end == p) goto fail;
        p = end;
    }
    /* reject trailing garbage: a truncated/corrupt control file must fail
     * loudly rather than silently define a smaller model */
    while (*p && isspace((unsigned char)*p)) p++;
    if (*p) goto fail;
    free(buf);
    return 0;
fail:
    free(buf);
    return -1;
}

/* ------------------------------------------------------ .prf field files */

#define PODFS_MAX_COLS 64

/* Header lines through the one starting with "data,", then comma-separated
 * rows x,y,z,<vars> (CFDCodeIntegration.rst:39-54; 6 columns for velocity
 * models, 3+ns for multi-variable models).  The column count comes from the
 * "data," header itself.  points/u may be NULL to skip storing; returns the
 * row count or -1; *ns_out receives the variable-slot count (cols - 3).
 * expect_ns >= 0 enforces a slot count (mode files must match the mean). */
static long parse_prf(const char *path, long expect_np, long expect_ns,
                      double *points, double *u, long *ns_out)
{
    long len = 0;
    char *buf = read_all(path, &len);
    char *p, *end, *line;
    long rows = 0, ncols = 0, ns;
    if (!buf) return -1;

    /* skip header: advance past the line whose first token is "data,";
     * count its comma-separated column names */
    p = buf;
    while (*p) {
        line = p;
        while (*p && *p != '\n') p++;
        if (*p) p++;
        while (*line == ' ' || *line == '\t') line++;
        if (strncmp(line, "data,", 5) == 0) {
            const char *q = line;
            ncols = 0;
            while (q < p && *q != '\n') { if (*q == ',') ncols++; q++; }
            break;
        }
    }
    if (!*p || ncols < 4 || ncols > PODFS_MAX_COLS) { free(buf); return -1; }
    ns = ncols - 3;
    if (expect_ns >= 0 && ns != expect_ns) { free(buf); return -1; }
    if (ns_out) *ns_out = ns;

    while (*p) {
        double v[PODFS_MAX_COLS];
        long c;
        int ok = 1;
        /* skip blank lines */
        while (*p == '\n' || *p == '\r' || *p == ' ' || *p == '\t') p++;
        if (!*p) break;
        for (c = 0; c < ncols; c++) {
            v[c] = strtod(p, &end);
            if (end == p) { ok = 0; break; }
            p = end;
            while (*p == ',' || *p == ' ' || *p == '\t') p++;
        }
        /* a row that fails to parse is corruption, not end-of-data: blank
         * lines/whitespace were already consumed above, so fail instead of
         * silently shrinking the model to the rows parsed so far */
        if (!ok) { free(buf); return -1; }
        if (expect_np >= 0 && rows >= expect_np) { free(buf); return -1; }
        if (points) memcpy(points + rows * 3, v, 3 * sizeof(double));
        if (u) memcpy(u + rows * ns, v + 3, (size_t)ns * sizeof(double));
        rows++;
    }
    free(buf);
    return rows;
}

/* ----------------------------------------------------------- public API */

void podfs_free(podfs_model *m)
{
    if (!m) return;
    free(m->points); free(m->mean); free(m->modes);
    free(m->counts); free(m->offsets);
    free(m->k); free(m->cre); free(m->cim);
    free(m);
}

static podfs_model *podfs_load_impl(const char *dir)
{
    char path[4096];
    podfs_model *m = (podfs_model *)calloc(1, sizeof(podfs_model));
    long i, np;
    if (!m) return NULL;

    snprintf(path, sizeof(path), "%s/PODFS.dat", dir);
    if (parse_dat(m, path) != 0) { podfs_free(m); return NULL; }

    /* mean profile fixes the point count and the variable-slot count */
    snprintf(path, sizeof(path), "%s/PODFS_mean.prf", dir);
    np = parse_prf(path, -1, -1, NULL, NULL, &m->ns);
    if (np <= 0 || m->ns <= 0) { podfs_free(m); return NULL; }
    m->np = np;
    m->points = (double *)malloc(sizeof(double) * (size_t)np * 3);
    m->mean = (double *)malloc(sizeof(double) * (size_t)np * (size_t)m->ns);
    m->modes = (double *)malloc(sizeof(double) * (size_t)(m->nm ? m->nm : 1)
                                * (size_t)np * (size_t)m->ns);
    if (!m->points || !m->mean || !m->modes) { podfs_free(m); return NULL; }
    if (parse_prf(path, np, m->ns, m->points, m->mean, NULL) != np) {
        podfs_free(m); return NULL;
    }
    for (i = 0; i < m->nm; i++) {
        snprintf(path, sizeof(path), "%s/PODFS_mode_%04ld.prf", dir, i + 1);
        if (parse_prf(path, np, m->ns, NULL, m->modes + i * np * m->ns,
                      NULL) != np) {
            podfs_free(m); return NULL;
        }
    }
    return m;
}

podfs_model *podfs_load(const char *dir)
{
    podfs_model *m;
#ifdef PODFS_HAVE_USELOCALE
    /* parse under a thread-private C numeric locale so a host solver's
     * setlocale() (e.g. "de_DE" with ',' decimals) cannot break or alter
     * parsing of the '.'-decimal model files */
    locale_t c_loc = newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
    locale_t old = c_loc ? uselocale(c_loc) : (locale_t)0;
#endif
    m = podfs_load_impl(dir);
#ifdef PODFS_HAVE_USELOCALE
    if (c_loc) { uselocale(old); freelocale(c_loc); }
#endif
    return m;
}

long podfs_num_points(const podfs_model *m) { return m ? m->np : 0; }
long podfs_num_vars(const podfs_model *m) { return m ? m->ns : 0; }
long podfs_num_modes(const podfs_model *m) { return m ? m->nm : 0; }
double podfs_period(const podfs_model *m) { return m ? m->period : 0.0; }
const double *podfs_points(const podfs_model *m)
{
    return m ? m->points : NULL;
}

/* temporal factor b_i(t) = Re( sum_j c_ij * exp(2*pi*i*k_ij*t/T) ) */
static void temporal_factors(const podfs_model *m, double t, double *b)
{
    long i, j;
    const double w = 2.0 * M_PI * t / m->period;
    for (i = 0; i < m->nm; i++) {
        double acc = 0.0;
        for (j = m->offsets[i]; j < m->offsets[i + 1]; j++) {
            const double th = w * m->k[j];
            acc += m->cre[j] * cos(th) - m->cim[j] * sin(th);
        }
        b[i] = acc;
    }
}

static void eval_one(const podfs_model *m, const double *b, double alpha,
                     double *out)
{
    long i, p;
    const long n3 = m->np * m->ns;
    for (p = 0; p < n3; p++)
        out[p] = alpha * m->mean[p];
    for (i = 0; i < m->nm; i++) {
        const double bi = b[i];
        const double *phi = m->modes + i * n3;
        for (p = 0; p < n3; p++)
            out[p] += bi * phi[p];
    }
}

int podfs_eval(const podfs_model *m, double t, double alpha, double *out)
{
    double *b;
    if (!m || !out) return -1;
    b = (double *)malloc(sizeof(double) * (size_t)(m->nm ? m->nm : 1));
    if (!b) return -1;
    temporal_factors(m, t, b);
    eval_one(m, b, alpha, out);
    free(b);
    return 0;
}

int podfs_eval_batch(const podfs_model *m, const double *ts, long nt,
                     double alpha, double *out)
{
    long s;
    int err = 0;
    if (!m || !ts || !out || nt < 0) return -1;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (s = 0; s < nt; s++) {
        double bstack[256];
        double *b = m->nm <= 256 ? bstack
            : (double *)malloc(sizeof(double) * (size_t)m->nm);
        if (!b) {
            /* all failing threads store the same value, but make the
             * concurrent store well-defined */
#ifdef _OPENMP
#pragma omp atomic write
#endif
            err = -1;
            continue;
        }
        temporal_factors(m, ts[s], b);
        eval_one(m, b, alpha, out + s * m->np * m->ns);
        if (b != bstack) free(b);
    }
    return err;
}
