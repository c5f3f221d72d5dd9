/* Stand-in libasound for testing io/alsa.py's ctypes discipline without a
 * sound stack (GPU servers usually have none). Implements the exact symbol surface
 * io/alsa.py binds: a deterministic 440 Hz mono tone source with short
 * reads (prime-sized bursts), ONE injected overrun (-EPIPE) on the third
 * readi, strict parameter checking, and a two-entry device hint list.
 *
 * A copy of the JAX package's native/alsa_stub.c. Built by
 * pitchvis_tpu_torch/io/alsa.py::stub_library_path (utils/host_build.py,
 * gcc) into build/pitchvis_tpu_torch/; tests point PITCHVIS_ALSA_LIB at it.
 * Not loaded in production.
 */
#include <errno.h>
#include <math.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
  long pos;
  int readi_calls;
  int recovered;
  unsigned rate;
} stub_pcm;

int snd_pcm_open(void **pcmp, const char *name, int stream, int mode) {
  (void)mode;
  if (stream != 1 /* SND_PCM_STREAM_CAPTURE */) return -EINVAL;
  if (strcmp(name, "missing") == 0) return -ENOENT;
  stub_pcm *p = calloc(1, sizeof(stub_pcm));
  if (!p) return -ENOMEM;
  *pcmp = p;
  return 0;
}

int snd_pcm_set_params(void *pcm, int format, int access, unsigned channels,
                       unsigned rate, int soft_resample, unsigned latency_us) {
  (void)soft_resample;
  (void)latency_us;
  if (format != 14 /* FLOAT_LE */ || access != 3 /* RW_INTERLEAVED */ ||
      channels != 1)
    return -EINVAL;
  if (rate < 8000 || rate > 192000) return -EINVAL;
  ((stub_pcm *)pcm)->rate = rate;
  return 0;
}

long snd_pcm_readi(void *pcm, void *buffer, unsigned long size) {
  stub_pcm *p = (stub_pcm *)pcm;
  p->readi_calls++;
  if (p->readi_calls == 3 && !p->recovered) return -EPIPE; /* overrun */
  float *out = (float *)buffer;
  unsigned long n = size < 57 ? size : 57; /* short reads: prime burst */
  for (unsigned long i = 0; i < n; i++)
    out[i] =
        0.2f * sinf(2.0f * (float)M_PI * 440.0f * (float)(p->pos + i) /
                    (float)p->rate);
  p->pos += (long)n;
  return (long)n;
}

int snd_pcm_recover(void *pcm, int err, int silent) {
  (void)silent;
  if (err == -EPIPE) {
    ((stub_pcm *)pcm)->recovered = 1;
    return 0;
  }
  return err;
}

int snd_pcm_close(void *pcm) {
  free(pcm);
  return 0;
}

const char *snd_strerror(int errnum) {
  return strerror(-errnum);
}

/* --- device name hints: [capture mic, playback-only speaker, NULL] --- */

typedef struct {
  const char *name;
  const char *desc;
  const char *ioid; /* NULL = both directions */
} stub_hint;

static const stub_hint k_hints[] = {
    {"default", "Stub default device", NULL},
    {"hw:0,0", "Stub microphone", "Input"},
    {"hw:1,0", "Stub speakers", "Output"},
};

int snd_device_name_hint(int card, const char *iface, void ***hints) {
  (void)card;
  if (strcmp(iface, "pcm") != 0) return -EINVAL;
  void **arr = calloc(4, sizeof(void *));
  if (!arr) return -ENOMEM;
  for (int i = 0; i < 3; i++) arr[i] = (void *)&k_hints[i];
  arr[3] = NULL;
  *hints = arr;
  return 0;
}

char *snd_device_name_get_hint(const void *hint, const char *id) {
  const stub_hint *h = (const stub_hint *)hint;
  const char *v = NULL;
  if (strcmp(id, "NAME") == 0) v = h->name;
  else if (strcmp(id, "DESC") == 0) v = h->desc;
  else if (strcmp(id, "IOID") == 0) v = h->ioid;
  return v ? strdup(v) : NULL;
}

int snd_device_name_free_hint(void **hints) {
  free(hints);
  return 0;
}
