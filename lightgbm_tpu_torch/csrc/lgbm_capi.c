/*
 * C API for lightgbm_tpu_torch — the reference's integration surface
 * (include/LightGBM/c_api.h, ~55 LGBM_* exports; src/c_api.cpp).
 *
 * A copy of capi/lgbm_capi.c that forwards every call to the PyTorch port
 * (lightgbm_tpu_torch.capi_impl) instead of the JAX package; the two files
 * differ only in this comment and the module name. Buffers cross as raw
 * addresses; handles are registry integers. Works in two hosting modes:
 *   - embedded: a plain C program links this library; the first call
 *     initializes a CPython interpreter in-process;
 *   - hosted: the library is dlopen'd inside an existing Python process
 *     (ctypes); the interpreter is reused via PyGILState.
 *
 * Build: lightgbm_tpu_torch.capi_shim.build_shim() (cc with the flags of
 * python3-config --includes / --ldflags --embed, into
 * lightgbm_tpu_torch/build/lib_lightgbm_tpu_torch_<key>.so).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

typedef void* DatasetHandle;
typedef void* BoosterHandle;

#define LGBM_EXPORT __attribute__((visibility("default")))

/* thread-local like the reference (c_api.cpp LGBM_GetLastError) */
static __thread char g_last_error[4096] = "everything is fine";

LGBM_EXPORT const char* LGBM_GetLastError(void) { return g_last_error; }

/* exported for external bindings that surface their own errors through the
   same channel (reference c_api.h LGBM_SetLastError, used by the R shim) */
LGBM_EXPORT void LGBM_SetLastError(const char* msg) {
  snprintf(g_last_error, sizeof(g_last_error), "%s", msg ? msg : "unknown");
}

static void set_error_from_python(void) {
  PyObject *type = NULL, *value = NULL, *tb = NULL;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  if (value != NULL) {
    PyObject* s = PyObject_Str(value);
    if (s != NULL) {
      const char* msg = PyUnicode_AsUTF8(s);
      snprintf(g_last_error, sizeof(g_last_error), "%s",
               msg ? msg : "unknown python error");
      Py_DECREF(s);
    }
  } else {
    snprintf(g_last_error, sizeof(g_last_error), "unknown error");
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

static int ensure_python(void) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    /* release the GIL acquired by initialization so PyGILState_Ensure
       works uniformly below */
    PyEval_SaveThread();
  }
  return 0;
}

/* call lightgbm_tpu_torch.capi_impl.<fn>(args...); returns new ref or NULL */
static PyObject* call_impl(const char* fn, const char* fmt, ...) {
  PyObject* module = PyImport_ImportModule("lightgbm_tpu_torch.capi_impl");
  if (module == NULL) return NULL;
  PyObject* func = PyObject_GetAttrString(module, fn);
  Py_DECREF(module);
  if (func == NULL) return NULL;
  va_list va;
  va_start(va, fmt);
  PyObject* args = Py_VaBuildValue(fmt, va);
  va_end(va);
  if (args == NULL) { Py_DECREF(func); return NULL; }
  if (!PyTuple_Check(args)) {
    PyObject* t = PyTuple_Pack(1, args);
    Py_DECREF(args);
    args = t;
    if (args == NULL) { Py_DECREF(func); return NULL; }
  }
  PyObject* out = PyObject_CallObject(func, args);
  Py_DECREF(args);
  Py_DECREF(func);
  return out;
}

/* boilerplate: run a call, store int64/double result, return 0/-1 */
#define BEGIN_CALL()                         \
  ensure_python();                           \
  PyGILState_STATE gil = PyGILState_Ensure(); \
  int ret = 0;                               \
  PyObject* out = NULL;

#define END_CALL()                           \
  if (out == NULL) { set_error_from_python(); ret = -1; } \
  Py_XDECREF(out);                           \
  PyGILState_Release(gil);                   \
  return ret;

static int64_t as_i64(PyObject* o) {
  return (o && o != Py_None) ? PyLong_AsLongLong(o) : 0;
}

/* ------------------------------------------------------------------ dataset */

LGBM_EXPORT int LGBM_DatasetCreateFromFile(const char* filename,
                                           const char* parameters,
                                           const DatasetHandle reference,
                                           DatasetHandle* out_handle) {
  BEGIN_CALL();
  out = call_impl("dataset_create_from_file", "(ssL)", filename,
                  parameters ? parameters : "", (long long)(intptr_t)reference);
  if (out != NULL) *out_handle = (DatasetHandle)(intptr_t)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetCreateFromMat(const void* data, int data_type,
                                          int32_t nrow, int32_t ncol,
                                          int is_row_major,
                                          const char* parameters,
                                          const DatasetHandle reference,
                                          DatasetHandle* out_handle) {
  BEGIN_CALL();
  out = call_impl("dataset_create_from_mat", "(LiiiisL)",
                  (long long)(intptr_t)data, data_type, (int)nrow, (int)ncol,
                  is_row_major, parameters ? parameters : "",
                  (long long)(intptr_t)reference);
  if (out != NULL) *out_handle = (DatasetHandle)(intptr_t)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetCreateFromCSR(const void* indptr, int indptr_type,
                                          const int32_t* indices,
                                          const void* data, int data_type,
                                          int64_t nindptr, int64_t nelem,
                                          int64_t num_col,
                                          const char* parameters,
                                          const DatasetHandle reference,
                                          DatasetHandle* out_handle) {
  BEGIN_CALL();
  out = call_impl("dataset_create_from_csr", "(LiLLiLLLsL)",
                  (long long)(intptr_t)indptr, indptr_type,
                  (long long)(intptr_t)indices, (long long)(intptr_t)data,
                  data_type, (long long)nindptr, (long long)nelem,
                  (long long)num_col, parameters ? parameters : "",
                  (long long)(intptr_t)reference);
  if (out != NULL) *out_handle = (DatasetHandle)(intptr_t)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetCreateFromCSC(const void* col_ptr,
                                          int col_ptr_type,
                                          const int32_t* indices,
                                          const void* data, int data_type,
                                          int64_t ncol_ptr, int64_t nelem,
                                          int64_t num_row,
                                          const char* parameters,
                                          const DatasetHandle reference,
                                          DatasetHandle* out_handle) {
  BEGIN_CALL();
  out = call_impl("dataset_create_from_csc", "(LiLLiLLLsL)",
                  (long long)(intptr_t)col_ptr, col_ptr_type,
                  (long long)(intptr_t)indices, (long long)(intptr_t)data,
                  data_type, (long long)ncol_ptr, (long long)nelem,
                  (long long)num_row, parameters ? parameters : "",
                  (long long)(intptr_t)reference);
  if (out != NULL) *out_handle = (DatasetHandle)(intptr_t)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetGetSubset(const DatasetHandle handle,
                                      const int32_t* used_row_indices,
                                      int32_t num_used_row_indices,
                                      const char* parameters,
                                      DatasetHandle* out_handle) {
  BEGIN_CALL();
  out = call_impl("dataset_get_subset", "(LLis)",
                  (long long)(intptr_t)handle,
                  (long long)(intptr_t)used_row_indices,
                  (int)num_used_row_indices, parameters ? parameters : "");
  if (out != NULL) *out_handle = (DatasetHandle)(intptr_t)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                            const char** feature_names,
                                            int num_feature_names) {
  BEGIN_CALL();
  PyObject* names = PyList_New(num_feature_names);
  for (int i = 0; i < num_feature_names; i++)
    PyList_SetItem(names, i, PyUnicode_FromString(feature_names[i]));
  out = call_impl("dataset_set_feature_names", "(LO)",
                  (long long)(intptr_t)handle, names);
  Py_DECREF(names);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetGetFeatureNames(DatasetHandle handle,
                                            char** feature_names,
                                            int* num_feature_names) {
  BEGIN_CALL();
  out = call_impl("dataset_get_feature_names", "(LL)",
                  (long long)(intptr_t)handle,
                  (long long)(intptr_t)feature_names);
  if (out != NULL) *num_feature_names = (int)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetCreateFromSampledColumn(double** sample_data,
                                                    int** sample_indices,
                                                    int32_t ncol,
                                                    const int* num_per_col,
                                                    int32_t num_sample_row,
                                                    int32_t num_total_row,
                                                    const char* parameters,
                                                    DatasetHandle* out_handle) {
  BEGIN_CALL();
  out = call_impl("dataset_create_from_sampled_column", "(LLiLiis)",
                  (long long)(intptr_t)sample_data,
                  (long long)(intptr_t)sample_indices, (int)ncol,
                  (long long)(intptr_t)num_per_col, (int)num_sample_row,
                  (int)num_total_row, parameters ? parameters : "");
  if (out != NULL) *out_handle = (DatasetHandle)(intptr_t)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetCreateByReference(const DatasetHandle reference,
                                              int64_t num_total_row,
                                              DatasetHandle* out_handle) {
  BEGIN_CALL();
  out = call_impl("dataset_create_by_reference", "(LL)",
                  (long long)(intptr_t)reference, (long long)num_total_row);
  if (out != NULL) *out_handle = (DatasetHandle)(intptr_t)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetPushRows(DatasetHandle dataset, const void* data,
                                     int data_type, int32_t nrow, int32_t ncol,
                                     int32_t start_row) {
  BEGIN_CALL();
  out = call_impl("dataset_push_rows", "(LLiiii)",
                  (long long)(intptr_t)dataset, (long long)(intptr_t)data,
                  data_type, (int)nrow, (int)ncol, (int)start_row);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetPushRowsByCSR(DatasetHandle dataset,
                                          const void* indptr, int indptr_type,
                                          const int32_t* indices,
                                          const void* data, int data_type,
                                          int64_t nindptr, int64_t nelem,
                                          int64_t num_col, int64_t start_row) {
  BEGIN_CALL();
  out = call_impl("dataset_push_rows_by_csr", "(LLiLLiLLLL)",
                  (long long)(intptr_t)dataset, (long long)(intptr_t)indptr,
                  indptr_type, (long long)(intptr_t)indices,
                  (long long)(intptr_t)data, data_type, (long long)nindptr,
                  (long long)nelem, (long long)num_col, (long long)start_row);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetFree(DatasetHandle handle) {
  BEGIN_CALL();
  out = call_impl("free_handle", "(L)", (long long)(intptr_t)handle);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetSaveBinary(DatasetHandle handle,
                                       const char* filename) {
  BEGIN_CALL();
  out = call_impl("dataset_save_binary", "(Ls)",
                  (long long)(intptr_t)handle, filename);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetSetField(DatasetHandle handle,
                                     const char* field_name,
                                     const void* field_data, int num_element,
                                     int type) {
  BEGIN_CALL();
  out = call_impl("dataset_set_field", "(LsLii)",
                  (long long)(intptr_t)handle, field_name,
                  (long long)(intptr_t)field_data, num_element, type);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetGetField(DatasetHandle handle,
                                     const char* field_name, int* out_len,
                                     const void** out_ptr, int* out_type) {
  BEGIN_CALL();
  out = call_impl("dataset_get_field", "(LsLL)",
                  (long long)(intptr_t)handle, field_name,
                  (long long)(intptr_t)out_ptr, (long long)(intptr_t)out_type);
  if (out != NULL) *out_len = (int)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetGetNumData(DatasetHandle handle, int* out_val) {
  BEGIN_CALL();
  out = call_impl("dataset_get_num_data", "(L)", (long long)(intptr_t)handle);
  if (out != NULL) *out_val = (int)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_DatasetGetNumFeature(DatasetHandle handle, int* out_val) {
  BEGIN_CALL();
  out = call_impl("dataset_get_num_feature", "(L)",
                  (long long)(intptr_t)handle);
  if (out != NULL) *out_val = (int)as_i64(out);
  END_CALL();
}

/* ------------------------------------------------------------------ booster */

LGBM_EXPORT int LGBM_BoosterCreate(const DatasetHandle train_data,
                                   const char* parameters,
                                   BoosterHandle* out_handle) {
  BEGIN_CALL();
  out = call_impl("booster_create", "(Ls)", (long long)(intptr_t)train_data,
                  parameters ? parameters : "");
  if (out != NULL) *out_handle = (BoosterHandle)(intptr_t)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterCreateFromModelfile(const char* filename,
                                                int* out_num_iterations,
                                                BoosterHandle* out_handle) {
  BEGIN_CALL();
  out = call_impl("booster_create_from_modelfile", "(s)", filename);
  if (out != NULL) {
    *out_handle = (BoosterHandle)(intptr_t)as_i64(out);
    Py_DECREF(out);
    out = call_impl("booster_get_current_iteration", "(L)",
                    (long long)(intptr_t)*out_handle);
    if (out != NULL) *out_num_iterations = (int)as_i64(out);
  }
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterLoadModelFromString(const char* model_str,
                                                int* out_num_iterations,
                                                BoosterHandle* out_handle) {
  BEGIN_CALL();
  out = call_impl("booster_load_from_string", "(s)", model_str);
  if (out != NULL) {
    *out_handle = (BoosterHandle)(intptr_t)as_i64(out);
    Py_DECREF(out);
    out = call_impl("booster_get_current_iteration", "(L)",
                    (long long)(intptr_t)*out_handle);
    if (out != NULL) *out_num_iterations = (int)as_i64(out);
  }
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterFree(BoosterHandle handle) {
  BEGIN_CALL();
  out = call_impl("free_handle", "(L)", (long long)(intptr_t)handle);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterAddValidData(BoosterHandle handle,
                                         const DatasetHandle valid_data) {
  BEGIN_CALL();
  out = call_impl("booster_add_valid_data", "(LL)",
                  (long long)(intptr_t)handle,
                  (long long)(intptr_t)valid_data);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                              const DatasetHandle train_data) {
  BEGIN_CALL();
  out = call_impl("booster_reset_training_data", "(LL)",
                  (long long)(intptr_t)handle,
                  (long long)(intptr_t)train_data);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterResetParameter(BoosterHandle handle,
                                           const char* parameters) {
  BEGIN_CALL();
  out = call_impl("booster_reset_parameter", "(Ls)",
                  (long long)(intptr_t)handle, parameters ? parameters : "");
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len) {
  BEGIN_CALL();
  out = call_impl("booster_get_num_classes", "(L)",
                  (long long)(intptr_t)handle);
  if (out != NULL) *out_len = (int)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterUpdateOneIter(BoosterHandle handle,
                                          int* is_finished) {
  BEGIN_CALL();
  out = call_impl("booster_update_one_iter", "(L)",
                  (long long)(intptr_t)handle);
  if (out != NULL) *is_finished = (int)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle,
                                                const float* grad,
                                                const float* hess,
                                                int* is_finished) {
  BEGIN_CALL();
  /* length comes from the booster's training set inside capi_impl */
  PyObject* n = call_impl("dataset_get_num_data_of_booster", "(L)",
                          (long long)(intptr_t)handle);
  if (n == NULL) { set_error_from_python(); PyGILState_Release(gil); return -1; }
  long long nn = as_i64(n);
  Py_DECREF(n);
  out = call_impl("booster_update_one_iter_custom", "(LLLL)",
                  (long long)(intptr_t)handle, (long long)(intptr_t)grad,
                  (long long)(intptr_t)hess, nn);
  if (out != NULL) *is_finished = (int)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterRollbackOneIter(BoosterHandle handle) {
  BEGIN_CALL();
  out = call_impl("booster_rollback_one_iter", "(L)",
                  (long long)(intptr_t)handle);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterMerge(BoosterHandle handle,
                                  BoosterHandle other_handle) {
  BEGIN_CALL();
  out = call_impl("booster_merge", "(LL)", (long long)(intptr_t)handle,
                  (long long)(intptr_t)other_handle);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterGetNumPredict(BoosterHandle handle, int data_idx,
                                          int64_t* out_len) {
  BEGIN_CALL();
  out = call_impl("booster_get_num_predict", "(Li)",
                  (long long)(intptr_t)handle, data_idx);
  if (out != NULL) *out_len = as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterGetPredict(BoosterHandle handle, int data_idx,
                                       int64_t* out_len, double* out_result) {
  BEGIN_CALL();
  out = call_impl("booster_get_predict", "(LiL)",
                  (long long)(intptr_t)handle, data_idx,
                  (long long)(intptr_t)out_result);
  if (out != NULL) *out_len = as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterGetCurrentIteration(BoosterHandle handle,
                                                int* out_iteration) {
  BEGIN_CALL();
  out = call_impl("booster_get_current_iteration", "(L)",
                  (long long)(intptr_t)handle);
  if (out != NULL) *out_iteration = (int)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterGetEvalCounts(BoosterHandle handle, int* out_len) {
  BEGIN_CALL();
  out = call_impl("booster_get_eval_counts", "(L)",
                  (long long)(intptr_t)handle);
  if (out != NULL) *out_len = (int)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterGetEvalNames(BoosterHandle handle, int* out_len,
                                         char** out_strs) {
  BEGIN_CALL();
  out = call_impl("booster_get_eval_names", "(LL)",
                  (long long)(intptr_t)handle, (long long)(intptr_t)out_strs);
  if (out != NULL) *out_len = (int)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterGetFeatureNames(BoosterHandle handle,
                                            int* out_len, char** out_strs) {
  BEGIN_CALL();
  out = call_impl("booster_get_feature_names", "(LL)",
                  (long long)(intptr_t)handle, (long long)(intptr_t)out_strs);
  if (out != NULL) *out_len = (int)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out_len) {
  BEGIN_CALL();
  out = call_impl("booster_get_num_feature", "(L)",
                  (long long)(intptr_t)handle);
  if (out != NULL) *out_len = (int)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterGetEval(BoosterHandle handle, int data_idx,
                                    int* out_len, double* out_results) {
  BEGIN_CALL();
  out = call_impl("booster_get_eval", "(LiL)", (long long)(intptr_t)handle,
                  data_idx, (long long)(intptr_t)out_results);
  if (out != NULL) *out_len = (int)as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterCalcNumPredict(BoosterHandle handle, int num_row,
                                           int predict_type, int num_iteration,
                                           int64_t* out_len) {
  BEGIN_CALL();
  out = call_impl("booster_calc_num_predict", "(Liii)",
                  (long long)(intptr_t)handle, num_row, predict_type,
                  num_iteration);
  if (out != NULL) *out_len = as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterPredictForMat(BoosterHandle handle,
                                          const void* data, int data_type,
                                          int32_t nrow, int32_t ncol,
                                          int is_row_major, int predict_type,
                                          int num_iteration,
                                          const char* parameter,
                                          int64_t* out_len,
                                          double* out_result) {
  BEGIN_CALL();
  out = call_impl("booster_predict_for_mat", "(LLiiiiiisL)",
                  (long long)(intptr_t)handle, (long long)(intptr_t)data,
                  data_type, (int)nrow, (int)ncol, is_row_major, predict_type,
                  num_iteration, parameter ? parameter : "",
                  (long long)(intptr_t)out_result);
  if (out != NULL) *out_len = as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterPredictForCSR(BoosterHandle handle,
                                          const void* indptr, int indptr_type,
                                          const int32_t* indices,
                                          const void* data, int data_type,
                                          int64_t nindptr, int64_t nelem,
                                          int64_t num_col, int predict_type,
                                          int num_iteration,
                                          const char* parameter,
                                          int64_t* out_len,
                                          double* out_result) {
  BEGIN_CALL();
  out = call_impl("booster_predict_for_csr", "(LLiLLiLLLiisL)",
                  (long long)(intptr_t)handle, (long long)(intptr_t)indptr,
                  indptr_type, (long long)(intptr_t)indices,
                  (long long)(intptr_t)data, data_type, (long long)nindptr,
                  (long long)nelem, (long long)num_col, predict_type,
                  num_iteration, parameter ? parameter : "",
                  (long long)(intptr_t)out_result);
  if (out != NULL) *out_len = as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterPredictForCSC(BoosterHandle handle,
                                          const void* col_ptr,
                                          int col_ptr_type,
                                          const int32_t* indices,
                                          const void* data, int data_type,
                                          int64_t ncol_ptr, int64_t nelem,
                                          int64_t num_row, int predict_type,
                                          int num_iteration,
                                          const char* parameter,
                                          int64_t* out_len,
                                          double* out_result) {
  BEGIN_CALL();
  out = call_impl("booster_predict_for_csc", "(LLiLLiLLLiisL)",
                  (long long)(intptr_t)handle, (long long)(intptr_t)col_ptr,
                  col_ptr_type, (long long)(intptr_t)indices,
                  (long long)(intptr_t)data, data_type, (long long)ncol_ptr,
                  (long long)nelem, (long long)num_row, predict_type,
                  num_iteration, parameter ? parameter : "",
                  (long long)(intptr_t)out_result);
  if (out != NULL) *out_len = as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterPredictForFile(BoosterHandle handle,
                                           const char* data_filename,
                                           int data_has_header,
                                           int predict_type, int num_iteration,
                                           const char* parameter,
                                           const char* result_filename) {
  BEGIN_CALL();
  out = call_impl("booster_predict_for_file", "(Lsiiiss)",
                  (long long)(intptr_t)handle, data_filename, data_has_header,
                  predict_type, num_iteration, parameter ? parameter : "",
                  result_filename);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterSaveModel(BoosterHandle handle, int num_iteration,
                                      const char* filename) {
  BEGIN_CALL();
  out = call_impl("booster_save_model", "(Lis)", (long long)(intptr_t)handle,
                  num_iteration, filename);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterSaveModelToString(BoosterHandle handle,
                                              int num_iteration,
                                              int64_t buffer_len,
                                              int64_t* out_len, char* out_str) {
  BEGIN_CALL();
  out = call_impl("booster_save_model_to_string", "(LiLL)",
                  (long long)(intptr_t)handle, num_iteration,
                  (long long)buffer_len, (long long)(intptr_t)out_str);
  if (out != NULL) *out_len = as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterDumpModel(BoosterHandle handle, int num_iteration,
                                      int64_t buffer_len, int64_t* out_len,
                                      char* out_str) {
  BEGIN_CALL();
  out = call_impl("booster_dump_model", "(LiLL)", (long long)(intptr_t)handle,
                  num_iteration, (long long)buffer_len,
                  (long long)(intptr_t)out_str);
  if (out != NULL) *out_len = as_i64(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterGetLeafValue(BoosterHandle handle, int tree_idx,
                                         int leaf_idx, double* out_val) {
  BEGIN_CALL();
  out = call_impl("booster_get_leaf_value", "(Lii)",
                  (long long)(intptr_t)handle, tree_idx, leaf_idx);
  if (out != NULL) *out_val = PyFloat_AsDouble(out);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterSetLeafValue(BoosterHandle handle, int tree_idx,
                                         int leaf_idx, double val) {
  BEGIN_CALL();
  out = call_impl("booster_set_leaf_value", "(Liid)",
                  (long long)(intptr_t)handle, tree_idx, leaf_idx, val);
  END_CALL();
}

LGBM_EXPORT int LGBM_BoosterFeatureImportance(BoosterHandle handle,
                                              int num_iteration,
                                              int importance_type,
                                              double* out_results) {
  BEGIN_CALL();
  out = call_impl("booster_feature_importance", "(LiiL)",
                  (long long)(intptr_t)handle, num_iteration, importance_type,
                  (long long)(intptr_t)out_results);
  END_CALL();
}

LGBM_EXPORT int LGBM_NetworkInit(const char* machines, int local_listen_port,
                                 int listen_time_out, int num_machines) {
  BEGIN_CALL();
  out = call_impl("network_init", "(siii)", machines ? machines : "",
                  local_listen_port, listen_time_out, num_machines);
  END_CALL();
}

LGBM_EXPORT int LGBM_NetworkFree(void) {
  BEGIN_CALL();
  out = call_impl("network_free", "()");
  END_CALL();
}
