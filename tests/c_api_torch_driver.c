/* Driver of tokenizers_tpu_torch's C ABI (tests/test_torch_c_api.py on the
 * CPU, chip_smoke.py phase 17 on the card):
 *
 *   driver tokenizer.json DEVICE encode TEXT [PAIR]
 *   driver tokenizer.json DEVICE batch DOCS_FILE [--launches] [--pool]
 *   driver tokenizer.json DEVICE train CORPUS
 *
 * DEVICE "card" builds the tokenizer with tokenizers_create (on the card),
 * anything else with tokenizers_create_on_device (e.g. "cpu").
 * encode prints ids, type ids, tokens, offsets, word ids, special tokens
 * mask and the decode of the ids; batch encodes the NUL-separated
 * documents of DOCS_FILE with tokenizers_encode_batch and prints each
 * one's ids (with --launches, then the kernels' launch counts of the
 * embedded interpreter and whether a worker of its host pool took a
 * chunk of the batch; with --pool, the pool's workers are first brought
 * up and given the tokenizer by one batch left uncounted); train trains with a BpeTrainer config at vocab
 * 40 and prints the trained tokenizer's encode of "hug" and its vocab
 * size.  Exit code 1 and the library's last error on a failing status. */
#include <Python.h>
#include <stdbool.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef struct CTokenizer CTokenizer;
typedef struct CEncoding CEncoding;

extern const char *tokenizers_get_last_error(void);
extern CTokenizer *tokenizers_create(const char *json, int *status);
extern CTokenizer *tokenizers_create_on_device(const char *json, const char *device,
                                               int *status);
extern void tokenizers_free(CTokenizer *);
extern CEncoding *tokenizers_encode(CTokenizer *, const char *seq, const char *pair,
                                    bool add_special, size_t *len, int *status);
extern void tokenizers_encoding_free(CEncoding *);
extern size_t tokenizers_encoding_len(const CEncoding *);
extern void tokenizers_encoding_get_ids(const CEncoding *, uint32_t *, size_t);
extern void tokenizers_encoding_get_type_ids(const CEncoding *, uint32_t *, size_t);
extern void tokenizers_encoding_get_special_tokens_mask(const CEncoding *, uint32_t *,
                                                        size_t);
extern void tokenizers_encoding_get_tokens(const CEncoding *, char **, size_t);
extern void tokenizers_encoding_get_offsets(const CEncoding *, uint32_t *, size_t);
extern void tokenizers_encoding_get_word_ids(const CEncoding *, int32_t *, size_t);
extern char *tokenizers_decode(const CTokenizer *, const uint32_t *, size_t, bool, int *);
extern void tokenizers_free_string(char *);
extern char *tokenizers_get_vocab(const CTokenizer *, bool, int *);
extern CEncoding **tokenizers_encode_batch(CTokenizer *, const char **seqs, size_t n,
                                           bool add_special, int *status);
extern void tokenizers_encoding_array_free(CEncoding **, size_t n);
extern int tokenizers_train_from_files(CTokenizer *, const char **files, size_t n,
                                       const char *trainer_json, int *status);

static char *read_file(const char *path, long *size) {
  FILE *f = fopen(path, "rb");
  if (!f) return NULL;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  char *buf = malloc(n + 1);
  if (fread(buf, 1, n, f) != (size_t)n) {
    fclose(f);
    free(buf);
    return NULL;
  }
  buf[n] = 0;
  fclose(f);
  if (size) *size = n;
  return buf;
}

static int fail(const char *what) {
  const char *err = tokenizers_get_last_error();
  fprintf(stderr, "%s failed: %s\n", what, err ? err : "(no error)");
  return 1;
}

static void print_u32(const char *name, const uint32_t *v, size_t n) {
  printf("%s:", name);
  for (size_t i = 0; i < n; i++) printf(" %u", v[i]);
  printf("\n");
}

static int run_encode(CTokenizer *tok, const char *text, const char *pair) {
  int status = -1;
  size_t len = 0;
  CEncoding *enc = tokenizers_encode(tok, text, pair, true, &len, &status);
  if (!enc || status != 0) return fail("encode");
  uint32_t *u = malloc((2 * len + 1) * sizeof(uint32_t));
  int32_t *w = malloc((len + 1) * sizeof(int32_t));
  tokenizers_encoding_get_ids(enc, u, len);
  print_u32("ids", u, len);
  char *text_out = tokenizers_decode(tok, u, len, true, &status);
  tokenizers_encoding_get_type_ids(enc, u, len);
  print_u32("type_ids", u, len);
  tokenizers_encoding_get_special_tokens_mask(enc, u, len);
  print_u32("special_tokens_mask", u, len);
  tokenizers_encoding_get_offsets(enc, u, 2 * len);
  printf("offsets:");
  for (size_t i = 0; i < len; i++) printf(" %u-%u", u[2 * i], u[2 * i + 1]);
  printf("\n");
  tokenizers_encoding_get_word_ids(enc, w, len);
  printf("word_ids:");
  for (size_t i = 0; i < len; i++) printf(" %d", w[i]);
  printf("\n");
  char **tokens = calloc(len + 1, sizeof(char *));
  tokenizers_encoding_get_tokens(enc, tokens, len);
  printf("tokens:");
  for (size_t i = 0; i < len; i++) {
    printf(" %s", tokens[i] ? tokens[i] : "?");
    free(tokens[i]);
  }
  printf("\n");
  printf("decode: %s\n", text_out ? text_out : "(null)");
  tokenizers_free_string(text_out);
  free(tokens);
  free(u);
  free(w);
  tokenizers_encoding_free(enc);
  return 0;
}

static int run_python(const char *code) {
  PyGILState_STATE gil = PyGILState_Ensure();
  int r = PyRun_SimpleString(code);
  PyGILState_Release(gil);
  return r;
}

static int run_batch(CTokenizer *tok, const char *path, bool launches, bool pool) {
  long size = 0;
  char *buf = read_file(path, &size);
  if (!buf) {
    fprintf(stderr, "cannot read %s\n", path);
    return 2;
  }
  size_t n = 0, cap = 16;
  const char **docs = malloc(cap * sizeof(char *));
  for (long i = 0; i < size;) {
    if (n == cap) docs = realloc(docs, (cap *= 2) * sizeof(char *));
    docs[n++] = buf + i;
    i += (long)strlen(buf + i) + 1;
  }
  int status = -1;
  CEncoding **encs;
  if (pool) {
    if (run_python("from tokenizers_tpu_torch.utils.parallelism import start_pool\n"
                   "start_pool(wait=True)\n") != 0)
      return 1;
    encs = tokenizers_encode_batch(tok, docs, n, true, &status);
    if (!encs || status != 0) return fail("encode_batch");
    tokenizers_encoding_array_free(encs, n);
    if (run_python("from tokenizers_tpu_torch.utils.parallelism import start_pool\n"
                   "start_pool(wait=True).used = False\n") != 0)
      return 1;
  }
  encs = tokenizers_encode_batch(tok, docs, n, true, &status);
  if (!encs || status != 0) return fail("encode_batch");
  for (size_t i = 0; i < n; i++) {
    size_t len = tokenizers_encoding_len(encs[i]);
    uint32_t *ids = malloc((len + 1) * sizeof(uint32_t));
    tokenizers_encoding_get_ids(encs[i], ids, len);
    char name[32];
    snprintf(name, sizeof name, "ids[%zu]", i);
    print_u32(name, ids, len);
    free(ids);
  }
  tokenizers_encoding_array_free(encs, n);
  free(docs);
  free(buf);
  if (launches) {  /* the counts of the interpreter the library embeds */
    fflush(stdout);
    if (run_python("import json, sys\n"
                   "from tokenizers_tpu_torch.ops import layout_kernels as lk, merge_kernels as mk\n"
                   "from tokenizers_tpu_torch.utils import parallelism as P\n"
                   "print('launches: ' + json.dumps({**lk.LAUNCHES, **mk.LAUNCHES}))\n"
                   "print('pool: ' + json.dumps(P._pool is not None and P._pool.used))\n"
                   "sys.stdout.flush()\n") != 0)
      return 1;
  }
  return 0;
}

static int run_train(CTokenizer *tok, const char *corpus) {
  int status = -1;
  const char *files[1] = {corpus};
  if (tokenizers_train_from_files(tok, files, 1,
                                  "{\"type\": \"BpeTrainer\", \"vocab_size\": 40}",
                                  &status) != 0 || status != 0)
    return fail("train");
  size_t len = 0;
  CEncoding *enc = tokenizers_encode(tok, "hug", NULL, true, &len, &status);
  if (!enc || status != 0) return fail("post-train encode");
  uint32_t *ids = malloc((len + 1) * sizeof(uint32_t));
  tokenizers_encoding_get_ids(enc, ids, len);
  print_u32("trained_ids", ids, len);
  free(ids);
  tokenizers_encoding_free(enc);
  char *vocab = tokenizers_get_vocab(tok, true, &status);
  if (!vocab || status != 0) return fail("get_vocab");
  printf("vocab: %s\n", vocab);
  tokenizers_free_string(vocab);
  return 0;
}

int main(int argc, char **argv) {
  if (argc < 5) {
    fprintf(stderr, "usage: %s tokenizer.json DEVICE encode|batch|train ARG...\n", argv[0]);
    return 2;
  }
  char *json = read_file(argv[1], NULL);
  if (!json) {
    fprintf(stderr, "cannot read %s\n", argv[1]);
    return 2;
  }
  int status = -1;
  CTokenizer *tok = strcmp(argv[2], "card") == 0
                        ? tokenizers_create(json, &status)
                        : tokenizers_create_on_device(json, argv[2], &status);
  free(json);
  if (!tok || status != 0) return fail("create");
  int r = 2;
  if (strcmp(argv[3], "encode") == 0)
    r = run_encode(tok, argv[4], argc > 5 ? argv[5] : NULL);
  else if (strcmp(argv[3], "batch") == 0) {
    bool launches = false, pool = false;
    for (int i = 5; i < argc; i++) {
      launches |= strcmp(argv[i], "--launches") == 0;
      pool |= strcmp(argv[i], "--pool") == 0;
    }
    r = run_batch(tok, argv[4], launches, pool);
  } else if (strcmp(argv[3], "train") == 0)
    r = run_train(tok, argv[4]);
  tokenizers_free(tok);
  fflush(stdout);
  return r;
}
