// C ABI of tokenizers_tpu_torch; counterpart of the JAX package's
// native/c_api.cpp (reference parity: `bindings/c/src/lib.rs` --
// CTokenizer / CEncoding flattened arrays, JSON-payload constructors,
// thread-local last error).
//
// It embeds CPython and forwards to tokenizers_tpu_torch (and imports no
// other package), flattening each Encoding into C-owned arrays at encode
// time so callers never touch Python objects.  Every symbol keeps the
// name, argument order, status codes and buffer conventions of the JAX
// package's C ABI, so its callers (tests/c_api_driver.c, the Node
// binding) link against either.  One constructor is added:
// tokenizers_create_on_device(json, device, status) builds the tokenizer
// on `device` ("cpu" runs every kernel's plain version); tokenizers_create
// builds it on the card and fails (status 2) without one.  A trainer
// config passed to tokenizers_train_from_files trains on the tokenizer's
// device.
//
// Build: tokenizers_tpu_torch/native/__init__.py (build_c_api) runs g++
// with the running interpreter's headers and libpython.

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;
thread_local bool g_has_error = false;

void set_last_error(const std::string &msg) {
  g_last_error = msg;
  g_has_error = true;
}

void clear_last_error() { g_has_error = false; }

void set_status(int *status, int value) {
  if (status != nullptr) *status = value;
}

// ---------------------------------------------------------------- python

std::string py_err_string() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  std::string out = "python error";
  if (value != nullptr) {
    PyObject *s = PyObject_Str(value);
    if (s != nullptr) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c != nullptr) out = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return out;
}

PyObject *g_module = nullptr;  // tokenizers_tpu_torch

// Starts the interpreter (unless the host program did) and releases the
// lock it holds after starting, so that any thread may take it, then
// imports the package once.
bool ensure_python() {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    PyEval_SaveThread();
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  if (g_module == nullptr) {
    PyRun_SimpleString(
        "import sys\n"
        "if not getattr(sys, 'argv', None):\n"
        "    sys.argv = ['']\n");
    g_module = PyImport_ImportModule("tokenizers_tpu_torch");
    if (g_module == nullptr) {
      set_last_error("failed to import tokenizers_tpu_torch: " + py_err_string());
      PyGILState_Release(gil);
      return false;
    }
  }
  PyGILState_Release(gil);
  return true;
}

struct GIL {
  PyGILState_STATE state;
  GIL() : state(PyGILState_Ensure()) {}
  ~GIL() { PyGILState_Release(state); }
};

char *dup_cstring(const std::string &s) {
  char *out = static_cast<char *>(malloc(s.size() + 1));
  if (out != nullptr) {
    memcpy(out, s.data(), s.size());
    out[s.size()] = '\0';
  }
  return out;
}

}  // namespace

extern "C" {

struct CTokenizer {
  PyObject *tok;
};

struct CEncoding {
  std::vector<uint32_t> ids;
  std::vector<uint32_t> type_ids;
  std::vector<uint32_t> attention_mask;
  std::vector<uint32_t> special_tokens_mask;
  std::vector<int32_t> word_ids;      // -1 == None
  std::vector<int32_t> sequence_ids;  // -1 == None
  std::vector<uint32_t> offsets;      // pairs, 2 * n
  std::vector<std::string> tokens;
  std::vector<CEncoding *> overflowing;
  ~CEncoding() {
    for (CEncoding *e : overflowing) delete e;
  }
};

namespace {

bool fill_u32(PyObject *obj, const char *attr, std::vector<uint32_t> *out) {
  PyObject *seq = PyObject_GetAttrString(obj, attr);
  if (seq == nullptr) return false;
  PyObject *fast = PySequence_Fast(seq, "expected sequence");
  Py_DECREF(seq);
  if (fast == nullptr) return false;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  out->reserve(n);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *it = PySequence_Fast_GET_ITEM(fast, i);
    out->push_back(static_cast<uint32_t>(PyLong_AsLong(it)));
  }
  Py_DECREF(fast);
  return true;
}

bool fill_opt_i32(PyObject *obj, const char *attr, std::vector<int32_t> *out) {
  PyObject *seq = PyObject_GetAttrString(obj, attr);
  if (seq == nullptr) return false;
  PyObject *fast = PySequence_Fast(seq, "expected sequence");
  Py_DECREF(seq);
  if (fast == nullptr) return false;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  out->reserve(n);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *it = PySequence_Fast_GET_ITEM(fast, i);
    out->push_back(it == Py_None ? -1
                                 : static_cast<int32_t>(PyLong_AsLong(it)));
  }
  Py_DECREF(fast);
  return true;
}

CEncoding *encoding_from_py(PyObject *enc, bool with_overflowing = true) {
  CEncoding *out = new CEncoding();
  bool ok = fill_u32(enc, "ids", &out->ids) &&
            fill_u32(enc, "type_ids", &out->type_ids) &&
            fill_u32(enc, "attention_mask", &out->attention_mask) &&
            fill_u32(enc, "special_tokens_mask", &out->special_tokens_mask) &&
            fill_opt_i32(enc, "word_ids", &out->word_ids) &&
            fill_opt_i32(enc, "sequence_ids", &out->sequence_ids);
  if (ok) {
    PyObject *offs = PyObject_GetAttrString(enc, "offsets");
    if (offs != nullptr) {
      PyObject *fast = PySequence_Fast(offs, "expected sequence");
      Py_DECREF(offs);
      if (fast != nullptr) {
        Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
        out->offsets.reserve(2 * n);
        for (Py_ssize_t i = 0; i < n; i++) {
          PyObject *pr = PySequence_Fast_GET_ITEM(fast, i);
          PyObject *a = PySequence_GetItem(pr, 0);
          PyObject *b = PySequence_GetItem(pr, 1);
          out->offsets.push_back(static_cast<uint32_t>(PyLong_AsLong(a)));
          out->offsets.push_back(static_cast<uint32_t>(PyLong_AsLong(b)));
          Py_XDECREF(a);
          Py_XDECREF(b);
        }
        Py_DECREF(fast);
      }
    }
    PyObject *toks = PyObject_GetAttrString(enc, "tokens");
    if (toks != nullptr) {
      PyObject *fast = PySequence_Fast(toks, "expected sequence");
      Py_DECREF(toks);
      if (fast != nullptr) {
        Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
        out->tokens.reserve(n);
        for (Py_ssize_t i = 0; i < n; i++) {
          const char *c =
              PyUnicode_AsUTF8(PySequence_Fast_GET_ITEM(fast, i));
          out->tokens.push_back(c != nullptr ? c : "");
        }
        Py_DECREF(fast);
      }
    }
    if (with_overflowing) {
      PyObject *ovf = PyObject_GetAttrString(enc, "overflowing");
      if (ovf != nullptr) {
        PyObject *fast = PySequence_Fast(ovf, "expected sequence");
        Py_DECREF(ovf);
        if (fast != nullptr) {
          Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
          for (Py_ssize_t i = 0; i < n; i++) {
            out->overflowing.push_back(encoding_from_py(
                PySequence_Fast_GET_ITEM(fast, i), false));
          }
          Py_DECREF(fast);
        }
      }
    }
  }
  if (PyErr_Occurred()) PyErr_Clear();
  return out;
}

}  // namespace

const char *tokenizers_get_last_error() {
  return g_has_error ? g_last_error.c_str() : nullptr;
}

namespace {

CTokenizer *create_impl(const char *json, const char *device, int *status) {
  if (json == nullptr) {
    set_last_error("tokenizers_create received null pointer");
    set_status(status, 1);
    return nullptr;
  }
  if (!ensure_python()) {
    set_status(status, 4);
    return nullptr;
  }
  GIL gil;
  PyObject *cls = PyObject_GetAttrString(g_module, "Tokenizer");
  PyObject *tok = nullptr;
  if (cls != nullptr) {
    tok = device == nullptr
              ? PyObject_CallMethod(cls, "from_str", "s", json)
              : PyObject_CallMethod(cls, "from_str", "ss", json, device);
  }
  Py_XDECREF(cls);
  if (tok == nullptr) {
    set_last_error("tokenizers_create failed: " + py_err_string());
    set_status(status, 2);
    return nullptr;
  }
  clear_last_error();
  set_status(status, 0);
  CTokenizer *out = new CTokenizer();
  out->tok = tok;
  return out;
}

}  // namespace

CTokenizer *tokenizers_create(const char *json, int *status) {
  return create_impl(json, nullptr, status);
}

CTokenizer *tokenizers_create_on_device(const char *json, const char *device,
                                        int *status) {
  if (device == nullptr) {
    set_last_error("tokenizers_create_on_device received null pointer");
    set_status(status, 1);
    return nullptr;
  }
  return create_impl(json, device, status);
}

void tokenizers_free(CTokenizer *tokenizer) {
  if (tokenizer == nullptr) return;
  if (Py_IsInitialized()) {
    GIL gil;
    Py_XDECREF(tokenizer->tok);
  }
  delete tokenizer;
}

CEncoding *tokenizers_encode(CTokenizer *tokenizer, const char *sequence,
                             const char *pair, bool add_special_tokens,
                             size_t *len_ptr, int *status) {
  if (tokenizer == nullptr || sequence == nullptr) {
    set_last_error("tokenizers_encode received null pointer");
    set_status(status, 1);
    return nullptr;
  }
  GIL gil;
  // encode(sequence, pair=None, is_pretokenized=False,
  //        add_special_tokens=True) — pass the flag by keyword
  PyObject *method = PyObject_GetAttrString(tokenizer->tok, "encode");
  PyObject *args = pair == nullptr ? Py_BuildValue("(s)", sequence)
                                   : Py_BuildValue("(ss)", sequence, pair);
  PyObject *kwargs = Py_BuildValue(
      "{s:O}", "add_special_tokens", add_special_tokens ? Py_True : Py_False);
  PyObject *enc = (method != nullptr && args != nullptr && kwargs != nullptr)
                      ? PyObject_Call(method, args, kwargs)
                      : nullptr;
  Py_XDECREF(method);
  Py_XDECREF(args);
  Py_XDECREF(kwargs);
  if (enc == nullptr) {
    set_last_error("tokenizers_encode failed: " + py_err_string());
    set_status(status, 4);
    return nullptr;
  }
  CEncoding *out = encoding_from_py(enc);
  Py_DECREF(enc);
  if (len_ptr != nullptr) *len_ptr = out->ids.size();
  clear_last_error();
  set_status(status, 0);
  return out;
}

void tokenizers_encoding_free(CEncoding *encoding) { delete encoding; }

size_t tokenizers_encoding_len(const CEncoding *encoding) {
  return encoding == nullptr ? 0 : encoding->ids.size();
}

#define COPY_FN(name, field, ctype)                                       \
  void name(const CEncoding *encoding, ctype *buffer, size_t len) {       \
    if (encoding == nullptr || buffer == nullptr) return;                 \
    size_t n = len < encoding->field.size() ? len : encoding->field.size(); \
    for (size_t i = 0; i < n; i++) buffer[i] = encoding->field[i];        \
  }

COPY_FN(tokenizers_encoding_get_ids, ids, uint32_t)
COPY_FN(tokenizers_encoding_get_type_ids, type_ids, uint32_t)
COPY_FN(tokenizers_encoding_get_attention_mask, attention_mask, uint32_t)
COPY_FN(tokenizers_encoding_get_special_tokens_mask, special_tokens_mask,
        uint32_t)
COPY_FN(tokenizers_encoding_get_word_ids, word_ids, int32_t)
COPY_FN(tokenizers_encoding_get_sequence_ids, sequence_ids, int32_t)
COPY_FN(tokenizers_encoding_get_offsets, offsets, uint32_t)

void tokenizers_encoding_get_tokens(const CEncoding *encoding, char **buffer,
                                    size_t len) {
  if (encoding == nullptr || buffer == nullptr) return;
  size_t n = len < encoding->tokens.size() ? len : encoding->tokens.size();
  for (size_t i = 0; i < n; i++) buffer[i] = dup_cstring(encoding->tokens[i]);
}

size_t tokenizers_encoding_get_overflowing_count(const CEncoding *encoding) {
  return encoding == nullptr ? 0 : encoding->overflowing.size();
}

const CEncoding *tokenizers_encoding_get_overflowing(const CEncoding *encoding,
                                                     size_t index) {
  if (encoding == nullptr || index >= encoding->overflowing.size())
    return nullptr;
  return encoding->overflowing[index];
}

int32_t tokenizers_token_to_id(const CTokenizer *tokenizer, const char *token,
                               int *status) {
  if (tokenizer == nullptr || token == nullptr) {
    set_last_error("tokenizers_token_to_id received null pointer");
    set_status(status, 1);
    return -1;
  }
  GIL gil;
  PyObject *r = PyObject_CallMethod(tokenizer->tok, "token_to_id", "s", token);
  if (r == nullptr) {
    set_last_error("tokenizers_token_to_id failed: " + py_err_string());
    set_status(status, 2);
    return -1;
  }
  int32_t out = r == Py_None ? -1 : static_cast<int32_t>(PyLong_AsLong(r));
  Py_DECREF(r);
  clear_last_error();
  set_status(status, 0);
  return out;
}

char *tokenizers_id_to_token(const CTokenizer *tokenizer, uint32_t id,
                             int *status) {
  if (tokenizer == nullptr) {
    set_last_error("tokenizers_id_to_token received null pointer");
    set_status(status, 1);
    return nullptr;
  }
  GIL gil;
  PyObject *r =
      PyObject_CallMethod(tokenizer->tok, "id_to_token", "I", id);
  if (r == nullptr || r == Py_None) {
    Py_XDECREF(r);
    set_status(status, r == nullptr ? 2 : 3);
    if (PyErr_Occurred()) PyErr_Clear();
    return nullptr;
  }
  const char *c = PyUnicode_AsUTF8(r);
  char *out = c != nullptr ? dup_cstring(c) : nullptr;
  Py_DECREF(r);
  clear_last_error();
  set_status(status, 0);
  return out;
}

char *tokenizers_decode(const CTokenizer *tokenizer, const uint32_t *ids,
                        size_t len, bool skip_special_tokens, int *status) {
  if (tokenizer == nullptr || ids == nullptr) {
    set_last_error("tokenizers_decode received null pointer");
    set_status(status, 1);
    return nullptr;
  }
  GIL gil;
  PyObject *list = PyList_New(len);
  for (size_t i = 0; i < len; i++)
    PyList_SET_ITEM(list, i, PyLong_FromUnsignedLong(ids[i]));
  PyObject *r = PyObject_CallMethod(tokenizer->tok, "decode", "OO", list,
                                    skip_special_tokens ? Py_True : Py_False);
  Py_DECREF(list);
  if (r == nullptr) {
    set_last_error("tokenizers_decode failed: " + py_err_string());
    set_status(status, 2);
    return nullptr;
  }
  const char *c = PyUnicode_AsUTF8(r);
  char *out = c != nullptr ? dup_cstring(c) : nullptr;
  Py_DECREF(r);
  clear_last_error();
  set_status(status, 0);
  return out;
}

void tokenizers_free_string(char *ptr) { free(ptr); }

char *tokenizers_get_vocab(const CTokenizer *tokenizer, bool with_added,
                           int *status) {
  if (tokenizer == nullptr) {
    set_last_error("tokenizers_get_vocab received null pointer");
    set_status(status, 1);
    return nullptr;
  }
  GIL gil;
  PyObject *vocab = PyObject_CallMethod(tokenizer->tok, "get_vocab", "O",
                                        with_added ? Py_True : Py_False);
  if (vocab == nullptr) {
    set_last_error("tokenizers_get_vocab failed: " + py_err_string());
    set_status(status, 2);
    return nullptr;
  }
  PyObject *json_mod = PyImport_ImportModule("json");
  PyObject *dumped =
      json_mod != nullptr
          ? PyObject_CallMethod(json_mod, "dumps", "O", vocab)
          : nullptr;
  Py_XDECREF(json_mod);
  Py_DECREF(vocab);
  if (dumped == nullptr) {
    set_last_error("tokenizers_get_vocab serialization failed");
    set_status(status, 3);
    return nullptr;
  }
  const char *utf8 = PyUnicode_AsUTF8(dumped);
  if (utf8 == nullptr) {
    Py_DECREF(dumped);
    set_last_error("tokenizers_get_vocab: UTF-8 conversion failed");
    set_status(status, 3);
    return nullptr;
  }
  char *out = dup_cstring(utf8);
  Py_DECREF(dumped);
  clear_last_error();
  set_status(status, 0);
  return out;
}

char *tokenizers_get_config(const CTokenizer *tokenizer, bool pretty,
                            int *status) {
  if (tokenizer == nullptr) {
    set_last_error("tokenizers_get_config received null pointer");
    set_status(status, 1);
    return nullptr;
  }
  GIL gil;
  PyObject *r = PyObject_CallMethod(tokenizer->tok, "to_str", "O",
                                    pretty ? Py_True : Py_False);
  if (r == nullptr) {
    set_last_error("tokenizers_get_config failed: " + py_err_string());
    set_status(status, 2);
    return nullptr;
  }
  const char *utf8 = PyUnicode_AsUTF8(r);
  if (utf8 == nullptr) {
    Py_DECREF(r);
    set_last_error("tokenizers_get_config: UTF-8 conversion failed");
    set_status(status, 3);
    return nullptr;
  }
  char *out = dup_cstring(utf8);
  Py_DECREF(r);
  clear_last_error();
  set_status(status, 0);
  return out;
}

namespace {

int add_tokens_impl(CTokenizer *tokenizer, const char *tokens_json,
                    bool special, int *status) {
  if (tokenizer == nullptr || tokens_json == nullptr) {
    set_last_error("tokenizers_add_tokens received null pointer");
    set_status(status, 1);
    return -1;
  }
  GIL gil;
  PyObject *json_mod = PyImport_ImportModule("json");
  PyObject *payload =
      json_mod != nullptr
          ? PyObject_CallMethod(json_mod, "loads", "s", tokens_json)
          : nullptr;
  Py_XDECREF(json_mod);
  if (payload == nullptr) {
    set_last_error("tokenizers_add_tokens: invalid JSON payload");
    set_status(status, 2);
    if (PyErr_Occurred()) PyErr_Clear();
    return -1;
  }
  // payload: list of strings or {content, single_word, lstrip, rstrip,
  // normalized, special} objects (reference AddedTokenPayload)
  PyObject *at_cls = PyObject_GetAttrString(g_module, "AddedToken");
  PyObject *tokens = PyList_New(0);
  Py_ssize_t n = PySequence_Size(payload);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *item = PySequence_GetItem(payload, i);
    PyObject *tok_obj = nullptr;
    if (item != nullptr && PyUnicode_Check(item)) {
      tok_obj = PyObject_CallFunction(at_cls, "O", item);
      if (tok_obj != nullptr && special) {
        PyObject_SetAttrString(tok_obj, "special", Py_True);
        PyObject_SetAttrString(tok_obj, "normalized", Py_False);
      }
    } else if (item != nullptr && PyDict_Check(item)) {
      PyObject *content = PyDict_GetItemString(item, "content");
      tok_obj = PyObject_CallFunction(at_cls, "O", content);
      if (tok_obj != nullptr) {
        PyObject *sp = PyDict_GetItemString(item, "special");
        bool is_special = special || (sp != nullptr && PyObject_IsTrue(sp));
        PyObject_SetAttrString(tok_obj, "special",
                               is_special ? Py_True : Py_False);
        PyObject_SetAttrString(tok_obj, "normalized",
                               is_special ? Py_False : Py_True);
        const char *flags[] = {"single_word", "lstrip", "rstrip",
                               "normalized"};
        for (const char *f : flags) {
          PyObject *v = PyDict_GetItemString(item, f);
          if (v != nullptr && v != Py_None)
            PyObject_SetAttrString(tok_obj, f, v);
        }
      }
    }
    if (tok_obj != nullptr) {
      PyList_Append(tokens, tok_obj);
      Py_DECREF(tok_obj);
    }
    Py_XDECREF(item);
  }
  Py_XDECREF(at_cls);
  Py_DECREF(payload);
  const char *method = special ? "add_special_tokens" : "add_tokens";
  PyObject *r = PyObject_CallMethod(tokenizer->tok, method, "O", tokens);
  Py_DECREF(tokens);
  if (r == nullptr) {
    set_last_error(std::string("tokenizers_add_tokens failed: ") +
                   py_err_string());
    set_status(status, 3);
    return -1;
  }
  int out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  clear_last_error();
  set_status(status, 0);
  return out;
}

}  // namespace

int tokenizers_add_tokens(CTokenizer *tokenizer, const char *tokens_json,
                          int *status) {
  return add_tokens_impl(tokenizer, tokens_json, false, status);
}

int tokenizers_add_special_tokens(CTokenizer *tokenizer,
                                  const char *tokens_json, int *status) {
  return add_tokens_impl(tokenizer, tokens_json, true, status);
}

int tokenizers_num_special_tokens_to_add(const CTokenizer *tokenizer,
                                         bool is_pair, int *status) {
  if (tokenizer == nullptr) {
    set_status(status, 1);
    return 0;
  }
  GIL gil;
  PyObject *r = PyObject_CallMethod(tokenizer->tok,
                                    "num_special_tokens_to_add", "O",
                                    is_pair ? Py_True : Py_False);
  if (r == nullptr) {
    set_status(status, 2);
    if (PyErr_Occurred()) PyErr_Clear();
    return 0;
  }
  int out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  set_status(status, 0);
  return out;
}

int tokenizers_enable_padding(CTokenizer *tokenizer, int direction,
                              uint32_t pad_id, uint32_t pad_type_id,
                              const char *pad_token, int length,
                              int pad_to_multiple_of, int *status) {
  if (tokenizer == nullptr) {
    set_status(status, 1);
    return -1;
  }
  GIL gil;
  PyObject *kwargs = Py_BuildValue(
      "{s:s, s:I, s:I, s:s, s:O, s:O}", "direction",
      direction == 0 ? "left" : "right", "pad_id", pad_id, "pad_type_id",
      pad_type_id, "pad_token", pad_token != nullptr ? pad_token : "[PAD]",
      "length", length < 0 ? Py_None : PyLong_FromLong(length),
      "pad_to_multiple_of",
      pad_to_multiple_of <= 0 ? Py_None : PyLong_FromLong(pad_to_multiple_of));
  PyObject *method = PyObject_GetAttrString(tokenizer->tok, "enable_padding");
  PyObject *empty = PyTuple_New(0);
  PyObject *r = method != nullptr ? PyObject_Call(method, empty, kwargs)
                                  : nullptr;
  Py_XDECREF(method);
  Py_DECREF(empty);
  Py_XDECREF(kwargs);
  if (r == nullptr) {
    set_last_error("tokenizers_enable_padding failed: " + py_err_string());
    set_status(status, 2);
    return -1;
  }
  Py_DECREF(r);
  set_status(status, 0);
  return 0;
}

int tokenizers_disable_padding(CTokenizer *tokenizer, int *status) {
  if (tokenizer == nullptr) {
    set_status(status, 1);
    return -1;
  }
  GIL gil;
  PyObject *r = PyObject_CallMethod(tokenizer->tok, "no_padding", nullptr);
  if (r == nullptr) {
    set_status(status, 2);
    if (PyErr_Occurred()) PyErr_Clear();
    return -1;
  }
  Py_DECREF(r);
  set_status(status, 0);
  return 0;
}

int tokenizers_enable_truncation(CTokenizer *tokenizer, size_t max_length,
                                 size_t stride, int strategy, int direction,
                                 int *status) {
  if (tokenizer == nullptr) {
    set_status(status, 1);
    return -1;
  }
  GIL gil;
  const char *strat = strategy == 1   ? "only_first"
                      : strategy == 2 ? "only_second"
                                      : "longest_first";
  PyObject *kwargs = Py_BuildValue(
      "{s:n, s:s, s:s}", "stride", static_cast<Py_ssize_t>(stride),
      "strategy", strat, "direction", direction == 0 ? "left" : "right");
  PyObject *method =
      PyObject_GetAttrString(tokenizer->tok, "enable_truncation");
  PyObject *args = Py_BuildValue("(n)", static_cast<Py_ssize_t>(max_length));
  PyObject *r = method != nullptr ? PyObject_Call(method, args, kwargs)
                                  : nullptr;
  Py_XDECREF(method);
  Py_XDECREF(args);
  Py_XDECREF(kwargs);
  if (r == nullptr) {
    set_last_error("tokenizers_enable_truncation failed: " + py_err_string());
    set_status(status, 2);
    return -1;
  }
  Py_DECREF(r);
  set_status(status, 0);
  return 0;
}

int tokenizers_disable_truncation(CTokenizer *tokenizer, int *status) {
  if (tokenizer == nullptr) {
    set_status(status, 1);
    return -1;
  }
  GIL gil;
  PyObject *r = PyObject_CallMethod(tokenizer->tok, "no_truncation", nullptr);
  if (r == nullptr) {
    set_status(status, 2);
    if (PyErr_Occurred()) PyErr_Clear();
    return -1;
  }
  Py_DECREF(r);
  set_status(status, 0);
  return 0;
}

// Batch encode: returns a malloc'd array of n CEncoding pointers (each
// freed with tokenizers_encoding_free; the array itself with
// tokenizers_encoding_array_free).  Routes through encode_batch so the
// device engine amortizes the whole batch in one program.
CEncoding **tokenizers_encode_batch(CTokenizer *tokenizer,
                                    const char **sequences, size_t n,
                                    bool add_special_tokens, int *status) {
  if (tokenizer == nullptr || (sequences == nullptr && n > 0)) {
    set_last_error("tokenizers_encode_batch received null pointer");
    set_status(status, 1);
    return nullptr;
  }
  GIL gil;
  PyObject *list = PyList_New(static_cast<Py_ssize_t>(n));
  if (list == nullptr) {
    set_status(status, 4);
    return nullptr;
  }
  for (size_t i = 0; i < n; i++) {
    PyObject *s = PyUnicode_FromString(sequences[i]);
    if (s == nullptr) {
      Py_DECREF(list);
      set_last_error("tokenizers_encode_batch: invalid UTF-8 input");
      set_status(status, 1);
      return nullptr;
    }
    PyList_SET_ITEM(list, static_cast<Py_ssize_t>(i), s);
  }
  PyObject *method =
      PyObject_GetAttrString(tokenizer->tok, "encode_batch");
  PyObject *args = Py_BuildValue("(O)", list);
  PyObject *kwargs = Py_BuildValue(
      "{s:O}", "add_special_tokens", add_special_tokens ? Py_True : Py_False);
  PyObject *encs = (method != nullptr && args != nullptr && kwargs != nullptr)
                       ? PyObject_Call(method, args, kwargs)
                       : nullptr;
  Py_XDECREF(method);
  Py_XDECREF(args);
  Py_XDECREF(kwargs);
  Py_DECREF(list);
  if (encs == nullptr) {
    set_last_error("tokenizers_encode_batch failed: " + py_err_string());
    set_status(status, 4);
    return nullptr;
  }
  CEncoding **out =
      static_cast<CEncoding **>(malloc(sizeof(CEncoding *) * (n ? n : 1)));
  for (size_t i = 0; i < n; i++) {
    PyObject *e = PySequence_GetItem(encs, static_cast<Py_ssize_t>(i));
    out[i] = e != nullptr ? encoding_from_py(e) : nullptr;
    Py_XDECREF(e);
  }
  Py_DECREF(encs);
  clear_last_error();
  set_status(status, 0);
  return out;
}

void tokenizers_encoding_array_free(CEncoding **encodings, size_t n) {
  if (encodings == nullptr) return;
  for (size_t i = 0; i < n; i++) delete encodings[i];
  free(encodings);
}

// Train from files with a JSON trainer config {"type": "BpeTrainer"|
// "WordPieceTrainer"|"UnigramTrainer"|"WordLevelTrainer", ...kwargs} (null
// = the model's default trainer), mirroring Tokenizer.train.
int tokenizers_train_from_files(CTokenizer *tokenizer, const char **files,
                                size_t n, const char *trainer_json,
                                int *status) {
  if (tokenizer == nullptr || files == nullptr) {
    set_last_error("tokenizers_train_from_files received null pointer");
    set_status(status, 1);
    return -1;
  }
  GIL gil;
  PyObject *list = PyList_New(static_cast<Py_ssize_t>(n));
  for (size_t i = 0; i < n; i++) {
    PyList_SET_ITEM(list, static_cast<Py_ssize_t>(i),
                    PyUnicode_FromString(files[i]));
  }
  PyObject *trainer = Py_None;
  Py_INCREF(Py_None);
  if (trainer_json != nullptr) {
    Py_DECREF(Py_None);
    PyObject *helpers =
        PyImport_ImportModule("tokenizers_tpu_torch.serialization");
    PyObject *device = PyObject_GetAttrString(tokenizer->tok, "device");
    PyObject *device_str = device != nullptr ? PyObject_Str(device) : nullptr;
    trainer = helpers != nullptr && device_str != nullptr
                  ? PyObject_CallMethod(helpers, "trainer_from_json", "sO",
                                        trainer_json, device_str)
                  : nullptr;
    Py_XDECREF(device_str);
    Py_XDECREF(device);
    Py_XDECREF(helpers);
    if (trainer == nullptr) {
      Py_DECREF(list);
      set_last_error("tokenizers_train_from_files: bad trainer config: " +
                     py_err_string());
      set_status(status, 2);
      return -1;
    }
  }
  PyObject *r =
      PyObject_CallMethod(tokenizer->tok, "train", "OO", list, trainer);
  Py_DECREF(list);
  Py_DECREF(trainer);
  if (r == nullptr) {
    set_last_error("tokenizers_train_from_files failed: " + py_err_string());
    set_status(status, 3);
    return -1;
  }
  Py_DECREF(r);
  clear_last_error();
  set_status(status, 0);
  return 0;
}

}  // extern "C"
