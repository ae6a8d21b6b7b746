/* nns_custom_filter.hh — header-only C++ class adapter over the C ABI.
 *
 * Reference analog: tensor_filter_cpp
 * (ext/nnstreamer/tensor_filter/tensor_filter_cpp.cc — user-written C++
 * classes with getInputDim/getOutputDim/setInputDim/invoke registered as
 * filters). Here a class derives from nns::CustomFilter and ONE macro
 * emits the extern "C" vtable of nns_custom_filter.h, so the same .so
 * loads with:
 *     tensor_filter framework=custom model=/path/libmyfilter.so
 *
 * Usage:
 *     #include "nns_custom_filter.hh"
 *     class Doubler : public nns::CustomFilter {
 *      public:
 *       explicit Doubler(const std::string &options) {}
 *       bool get_info(nns_tensors_spec *in, nns_tensors_spec *out) override {
 *         ...fill specs...; return true;
 *       }
 *       int invoke(const nns_tensor_view *in, uint32_t n_in,
 *                  nns_tensor_view *out, uint32_t n_out) override { ... }
 *     };
 *     NNS_REGISTER_CUSTOM_FILTER(Doubler)
 *
 * Static-shape classes override get_info(); dynamic-shape classes
 * override set_input() (reference setInputDimension). The base class
 * implements each in terms of the other where possible, matching the
 * loader's fallback rules (backends/custom_c.py: a failing get_info is
 * tolerated, a PRESENT-but-failing set_input aborts negotiation).
 * Exceptions never cross the C boundary.
 */
#ifndef NNS_CUSTOM_FILTER_HH
#define NNS_CUSTOM_FILTER_HH

#include <string>

#include "nns_custom_filter.h"

namespace nns {

class CustomFilter {
 public:
  virtual ~CustomFilter() = default;

  /* Static-shape filters: declare both specs. */
  virtual bool get_info(nns_tensors_spec * /*in*/, nns_tensors_spec * /*out*/) {
    return false;
  }

  /* Dynamic-shape filters: derive the output spec from the negotiated
   * input. Default: a static filter's declared output works for any
   * accepted input (the loader's own fallback when set_input is absent). */
  virtual bool set_input(const nns_tensors_spec * /*in*/,
                         nns_tensors_spec *out) {
    nns_tensors_spec scratch_in;
    return get_info(&scratch_in, out);
  }

  virtual int invoke(const nns_tensor_view *in, uint32_t n_in,
                     nns_tensor_view *out, uint32_t n_out) = 0;
};

}  // namespace nns

#define NNS_REGISTER_CUSTOM_FILTER(CLASS)                                     \
  extern "C" {                                                                \
  int32_t nns_custom_abi_version(void) { return NNS_CUSTOM_ABI_VERSION; }     \
  void *nns_custom_open(const char *options) {                                \
    try {                                                                     \
      /* upcast BEFORE erasing the type: with multiple inheritance the     */ \
      /* CustomFilter base may not sit at the CLASS address, and the other */ \
      /* entries static_cast the void* back to CustomFilter*               */ \
      nns::CustomFilter *p = new CLASS(std::string(options ? options : "")); \
      return p;                                                               \
    } catch (...) {                                                           \
      return nullptr;                                                         \
    }                                                                         \
  }                                                                           \
  void nns_custom_close(void *h) {                                            \
    try {                                                                     \
      delete static_cast<nns::CustomFilter *>(h);                             \
    } catch (...) {                                                           \
    }                                                                         \
  }                                                                           \
  int nns_custom_invoke(void *h, const nns_tensor_view *in, uint32_t n_in,    \
                        nns_tensor_view *out, uint32_t n_out) {               \
    try {                                                                     \
      return static_cast<nns::CustomFilter *>(h)->invoke(in, n_in, out,       \
                                                         n_out);              \
    } catch (...) {                                                           \
      return -1;                                                              \
    }                                                                         \
  }                                                                           \
  int nns_custom_get_info(void *h, nns_tensors_spec *in_spec,                 \
                          nns_tensors_spec *out_spec) {                       \
    try {                                                                     \
      return static_cast<nns::CustomFilter *>(h)->get_info(in_spec, out_spec) \
                 ? 0                                                          \
                 : -1;                                                        \
    } catch (...) {                                                           \
      return -1;                                                              \
    }                                                                         \
  }                                                                           \
  int nns_custom_set_input(void *h, const nns_tensors_spec *in_spec,          \
                           nns_tensors_spec *out_spec) {                      \
    try {                                                                     \
      return static_cast<nns::CustomFilter *>(h)->set_input(in_spec,          \
                                                            out_spec)        \
                 ? 0                                                          \
                 : -1;                                                        \
    } catch (...) {                                                           \
      return -1;                                                              \
    }                                                                         \
  }                                                                           \
  } /* extern "C" */

#endif /* NNS_CUSTOM_FILTER_HH */
