/* podfs_replay.h — public C API for PODFS inlet-model replay.
 *
 * Evaluates the PODFS reconstruction equation of the reference framework
 * (docs/usage/CFDCodeIntegration.rst:85-91) from an on-disk model directory
 * (PODFS.dat + PODFS_mean.prf + PODFS_mode_%04i.prf).  Link against
 * libpodfs_replay.so (build: cc -O3 -fopenmp -shared -fPIC podfs_replay.c
 * -o libpodfs_replay.so -lm).  All arrays are row-major C doubles.
 *
 * Typical solver loop:
 *
 *   podfs_model *m = podfs_load("PODFS");
 *   long np = podfs_num_points(m);
 *   double *u = malloc(sizeof(double) * np * 3);
 *   // ... map podfs_points(m) (np x 3 x,y,z) onto your inlet faces once ...
 *   for (each timestep t)
 *       podfs_eval(m, fmod(t, podfs_period(m)), 1.0, u);  // np x 3 (u,v,w)
 *   podfs_free(m);
 */
#ifndef PODFS_REPLAY_H
#define PODFS_REPLAY_H

#ifdef __cplusplus
extern "C" {
#endif

typedef struct podfs_model podfs_model;

/* Load a model directory; NULL on any parse/IO failure (including trailing
 * garbage / truncated rows — corrupt files fail loudly, they never load as a
 * smaller model).  On POSIX hosts parsing runs under a private C numeric
 * locale, so a solver's setlocale() cannot affect it; on other platforms
 * keep LC_NUMERIC="C" while calling podfs_load. */
podfs_model *podfs_load(const char *dir);
void podfs_free(podfs_model *m);

long podfs_num_points(const podfs_model *m);
/* Variable slots per point, from the .prf "data," header: 3 (u,v,w) for
 * velocity models, 3 + number of scalars for multi-variable models. */
long podfs_num_vars(const podfs_model *m);
long podfs_num_modes(const podfs_model *m);
double podfs_period(const podfs_model *m);
/* (num_points x 3) x,y,z inlet point coordinates, owned by the model. */
const double *podfs_points(const podfs_model *m);

/* Field at one time: out is (num_points x num_vars) — u,v,w for velocity
 * models.  alpha scales the mean field (CFDCodeIntegration.rst:87-91).
 * Returns 0 on success. */
int podfs_eval(const podfs_model *m, double t, double alpha, double *out);

/* Batched: ts is (nt), out is (nt x num_points x num_vars).  OpenMP-parallel
 * over timesteps when compiled with -fopenmp. */
int podfs_eval_batch(const podfs_model *m, const double *ts, long nt,
                     double alpha, double *out);

#ifdef __cplusplus
}
#endif
#endif /* PODFS_REPLAY_H */
