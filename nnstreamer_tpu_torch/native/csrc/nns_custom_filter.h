/* nns_custom_filter.h — C ABI for user-written custom filter plugins.
 *
 * Reference analog: the raw-C custom filter interface of
 * gst/nnstreamer/tensor_filter/tensor_filter_custom.h (NNStreamer_custom_class:
 * init/exit/getInputDim/getOutputDim/setInputDim/invoke). Redesigned as a
 * plain-C symbol ABI (no GLib types): a plugin is any shared object exporting
 * the nns_custom_* symbols below; the Python pipeline loads it with
 *     tensor_filter framework=custom model=/path/libmyfilter.so custom=opts
 * through ctypes (backends/custom_c.py).
 *
 * Contract:
 *  - All functions are called from one pipeline thread at a time per handle.
 *  - Output buffers are allocated by the CALLER from the plugin's declared
 *    output spec; invoke() writes results in place (no plugin-side malloc
 *    crossing the boundary, unlike the reference's allocate_in_invoke).
 *  - Return 0 for success, negative for failure.
 */
#ifndef NNS_CUSTOM_FILTER_H
#define NNS_CUSTOM_FILTER_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define NNS_CUSTOM_ABI_VERSION 1
#define NNS_MAX_TENSORS 16
#define NNS_MAX_RANK 8

/* dtype codes (order matches nnstreamer_tpu.core.DataType) */
typedef enum {
  NNS_INT8 = 0,
  NNS_UINT8 = 1,
  NNS_INT16 = 2,
  NNS_UINT16 = 3,
  NNS_INT32 = 4,
  NNS_UINT32 = 5,
  NNS_INT64 = 6,
  NNS_UINT64 = 7,
  NNS_FLOAT16 = 8,
  NNS_FLOAT32 = 9,
  NNS_FLOAT64 = 10,
  NNS_BFLOAT16 = 11,
  NNS_BOOL = 12,
} nns_dtype;

typedef struct {
  int32_t dtype;  /* nns_dtype */
  int32_t rank;
  int64_t dims[NNS_MAX_RANK];
} nns_tensor_spec;

typedef struct {
  uint32_t num;
  nns_tensor_spec spec[NNS_MAX_TENSORS];
} nns_tensors_spec;

typedef struct {
  void *data;     /* const for inputs; caller-allocated for outputs */
  uint64_t size;  /* bytes */
} nns_tensor_view;

/* -- required exports ---------------------------------------------------- */

/* ABI version of the plugin; loader rejects mismatches. */
int32_t nns_custom_abi_version(void);

/* Create one filter instance. options = the element's custom= string (may be
 * empty, never NULL). Return NULL on failure. */
void *nns_custom_open(const char *options);

void nns_custom_close(void *handle);

/* Run one frame. in/out views are parallel to the negotiated specs. */
int nns_custom_invoke(void *handle, const nns_tensor_view *in, uint32_t n_in,
                      nns_tensor_view *out, uint32_t n_out);

/* -- optional exports (at least ONE of the two must be present) ---------- */

/* Static-shape plugins: declare both specs. Return 0 on success. */
int nns_custom_get_info(void *handle, nns_tensors_spec *in_spec,
                        nns_tensors_spec *out_spec);

/* Dynamic-shape plugins: given the negotiated input spec, fill the output
 * spec (reference setInputDimension). Return 0 on success. */
int nns_custom_set_input(void *handle, const nns_tensors_spec *in_spec,
                         nns_tensors_spec *out_spec);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* NNS_CUSTOM_FILTER_H */
