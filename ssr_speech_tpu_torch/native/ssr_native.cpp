// Native host-side runtime ops of the SSR-Speech PyTorch port (the same
// helpers as ssr_speech_tpu/native/ssr_native.cpp).
//
// The reference delegates its hot host paths to Python (codes/phoneme txt
// parsing in data/gigaspeech.py:43-64 runs per item per epoch inside
// DataLoader workers; the word-level Levenshtein alignment in
// edit_utils_en.py:10-66 is O(n*m) pure Python). These are the only
// CPU-bound inner loops in the system, so they live here in C++ and are
// bound via ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC ssr_native.cpp -o libssr_native.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// parse_int_matrix: read a whitespace-separated integer matrix text file
// (one row per line) into a caller-allocated int32 buffer.
// Returns 0 on success; fills n_rows/n_cols (ragged rows -> first row's
// length wins, short rows padded with pad_value, long rows truncated).
// ---------------------------------------------------------------------------
int parse_int_matrix(const char* path, int32_t* out, int max_rows,
                     int max_cols, int32_t pad_value, int* n_rows,
                     int* n_cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (size > 0 && fread(buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return -2;
  }
  fclose(f);
  buf[size] = '\0';

  int rows = 0;
  int cols = -1;
  const char* p = buf.data();
  const char* end = buf.data() + size;
  while (p < end && rows < max_rows) {
    // parse one line
    int col = 0;
    int32_t* row_out = out + (long)rows * max_cols;
    bool any = false;
    while (p < end && *p != '\n') {
      // skip spaces/tabs/CR
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
      if (p >= end || *p == '\n') break;
      bool neg = false;
      if (*p == '-') { neg = true; p++; }
      long v = 0;
      bool digit = false;
      while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10 + (*p - '0');
        p++;
        digit = true;
      }
      if (!digit) { // non-numeric token: skip it
        while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') p++;
        continue;
      }
      any = true;
      if (col < max_cols) row_out[col] = (int32_t)(neg ? -v : v);
      col++;
    }
    if (p < end) p++;  // consume newline
    if (!any) continue;  // skip empty lines
    if (cols < 0) cols = col < max_cols ? col : max_cols;
    for (int c = col; c < cols; c++) row_out[c] = pad_value;
    rows++;
  }
  *n_rows = rows;
  *n_cols = cols < 0 ? 0 : cols;
  return 0;
}

// ---------------------------------------------------------------------------
// levenshtein_ops: minimal-edit alignment between two int sequences with the
// reference's tie-breaking (deletion > insertion > substitution when equal,
// edit_utils_en.py:29-39). Emits ops as (src_start, src_end, kind) triples,
// kind: 0=del, 1=ins, 2=sub. Returns the edit distance, or -1 on overflow.
// ---------------------------------------------------------------------------
int levenshtein_ops(const int32_t* a, int n, const int32_t* b, int m,
                    int32_t* ops_out, int max_ops, int* n_ops) {
  std::vector<int32_t> dist((n + 1) * (m + 1));
  std::vector<int8_t> back((n + 1) * (m + 1));  // 0=diag,1=del,2=ins
  auto D = [&](int i, int j) -> int32_t& { return dist[i * (m + 1) + j]; };
  auto B = [&](int i, int j) -> int8_t& { return back[i * (m + 1) + j]; };
  for (int i = 0; i <= n; i++) { D(i, 0) = i; B(i, 0) = 1; }
  for (int j = 0; j <= m; j++) { D(0, j) = j; B(0, j) = 2; }
  B(0, 0) = 0;
  for (int i = 1; i <= n; i++) {
    for (int j = 1; j <= m; j++) {
      int cost = (a[i - 1] == b[j - 1]) ? 0 : 1;
      int del = D(i - 1, j) + 1;
      int ins = D(i, j - 1) + 1;
      int sub = D(i - 1, j - 1) + cost;
      int best = del < ins ? del : ins;
      best = best < sub ? best : sub;
      D(i, j) = best;
      if (best == del) B(i, j) = 1;
      else if (best == ins) B(i, j) = 2;
      else B(i, j) = 0;
    }
  }
  // backtrace (reverse order, same walk as edit_utils_en.py:42-64)
  std::vector<int32_t> rev;
  int i = n, j = m;
  while (i > 0 || j > 0) {
    int8_t bk = B(i, j);
    if (i > 0 && bk == 1) {
      rev.push_back(0); rev.push_back(i); rev.push_back(i - 1);
      i--;
    } else if (j > 0 && bk == 2) {
      rev.push_back(1); rev.push_back(i); rev.push_back(i);
      j--;
    } else {
      if (a[i - 1] != b[j - 1]) {
        rev.push_back(2); rev.push_back(i); rev.push_back(i - 1);
      }
      i--; j--;
    }
  }
  int count = (int)(rev.size() / 3);
  if (count > max_ops) return -1;
  for (int k = 0; k < count; k++) {
    // reverse into (start, end, kind)
    int src = (count - 1 - k) * 3;
    ops_out[k * 3 + 0] = rev[src + 2];
    ops_out[k * 3 + 1] = rev[src + 1];
    ops_out[k * 3 + 2] = rev[src + 0];
  }
  *n_ops = count;
  return D(n, m);
}

// ---------------------------------------------------------------------------
// pad_collate_i32: gather variable-length int32 rows into one padded matrix.
// Used by the batch collator; avoids a python loop over items x timesteps.
// srcs: array of row pointers; lens: row lengths.
// ---------------------------------------------------------------------------
void pad_collate_i32(const int32_t** srcs, const int32_t* lens, int n,
                     int32_t* out, int width, int32_t pad_value) {
  for (int i = 0; i < n; i++) {
    int l = lens[i] < width ? lens[i] : width;
    memcpy(out + (long)i * width, srcs[i], l * sizeof(int32_t));
    for (int c = l; c < width; c++) out[(long)i * width + c] = pad_value;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Threaded WAV segment loader for the codec-GAN training data path.
//
// The reference loads audio per item inside torch DataLoader workers
// (audiocraft/audiocraft/data/audio_dataset.py segment sampling +
// audio.py decode); our AudioSegmentDataset did the same work in a python
// loop over the batch. One call here reads, mono-mixes and segment-crops a
// whole batch in parallel (std::thread over files). Resampling is NOT done
// natively — a file whose rate differs from target_sr gets err=2 and the
// caller falls back to the python path (scipy polyphase) for that row.
// ---------------------------------------------------------------------------

#include <thread>
#include <atomic>

namespace {

// Parse one WAV file, mono-mix to float32 at native rate.
// Returns 0 ok; 1 io/parse error; 3 unsupported encoding.
// On success fills mono (resized) and *rate.
int read_wav_mono(const char* path, std::vector<float>* mono, int* rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<unsigned char> buf(size > 0 ? size : 0);
  if (size < 12 || fread(buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return 1;
  }
  fclose(f);
  if (memcmp(buf.data(), "RIFF", 4) || memcmp(buf.data() + 8, "WAVE", 4))
    return 1;
  long pos = 12;
  int audio_format = -1, channels = 0, bits = 0;
  const unsigned char* data = nullptr;
  long data_len = 0;
  while (pos + 8 <= size) {
    const unsigned char* cid = buf.data() + pos;
    uint32_t csize;
    memcpy(&csize, buf.data() + pos + 4, 4);
    const unsigned char* body = buf.data() + pos + 8;
    long avail = size - pos - 8;
    long clen = (long)csize < avail ? (long)csize : avail;
    if (!memcmp(cid, "fmt ", 4) && clen >= 16) {
      uint16_t fmt16, ch16, bits16;
      uint32_t rate32;
      memcpy(&fmt16, body, 2);
      memcpy(&ch16, body + 2, 2);
      memcpy(&rate32, body + 4, 4);
      memcpy(&bits16, body + 14, 2);
      audio_format = fmt16;
      channels = ch16;
      *rate = (int)rate32;
      bits = bits16;
    } else if (!memcmp(cid, "data", 4)) {
      data = body;
      data_len = clen;
    }
    // 64-bit advance: a corrupt csize near UINT32_MAX must not wrap to 0
    // and spin this loop forever inside a worker thread
    long adv = 8L + (long)csize + (long)(csize & 1);
    if (adv <= 8 && csize != 0) break;
    pos += adv;
  }
  if (audio_format < 0 || !data || channels <= 0) return 1;
  bool is_float = audio_format == 3 || (audio_format == 0xFFFE && bits == 32);
  long bytes_per = bits / 8;
  if (bytes_per <= 0) return 3;
  long n_frames = data_len / (bytes_per * channels);
  mono->assign(n_frames, 0.0f);
  float inv_ch = 1.0f / channels;
  if (is_float && bits == 32) {
    for (long t = 0; t < n_frames; t++) {
      float acc = 0.0f;
      for (int c = 0; c < channels; c++) {
        float v;
        memcpy(&v, data + (t * channels + c) * 4, 4);
        acc += v;
      }
      (*mono)[t] = acc * inv_ch;
    }
  } else if (bits == 16) {
    const int16_t* s = (const int16_t*)data;
    for (long t = 0; t < n_frames; t++) {
      float acc = 0.0f;
      for (int c = 0; c < channels; c++) acc += s[t * channels + c];
      (*mono)[t] = acc * inv_ch / 32768.0f;
    }
  } else if (bits == 24) {
    for (long t = 0; t < n_frames; t++) {
      float acc = 0.0f;
      for (int c = 0; c < channels; c++) {
        const unsigned char* b = data + (t * channels + c) * 3;
        int32_t v = b[0] | (b[1] << 8) | (b[2] << 16);
        if (v >= (1 << 23)) v -= (1 << 24);
        acc += (float)v / (float)(1 << 23);
      }
      (*mono)[t] = acc * inv_ch;
    }
  } else if (bits == 32 && !is_float) {
    const int32_t* s = (const int32_t*)data;
    for (long t = 0; t < n_frames; t++) {
      float acc = 0.0f;
      for (int c = 0; c < channels; c++)
        acc += (float)s[t * channels + c] / 2147483648.0f;
      (*mono)[t] = acc * inv_ch;
    }
  } else {
    return 3;
  }
  return 0;
}

}  // namespace

extern "C" {

// Load n WAV files into out[n, seg] float32 mono segments in parallel.
// fracs[i] in [0, 1) picks the crop start: start = frac * (len - seg + 1)
// (caller's RNG stays in python). Files shorter than seg are zero-padded.
// errs[i]: 0 ok; 1 io/parse; 2 needs resample (rate != target_sr);
// 3 unsupported encoding — caller python-fallbacks those rows.
void load_wav_batch(const char** paths, int n, int target_sr, long seg,
                    const double* fracs, float* out, int32_t* errs,
                    int n_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    std::vector<float> mono;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      float* row = out + (long)i * seg;
      int rate = 0;
      int err = read_wav_mono(paths[i], &mono, &rate);
      if (!err && rate != target_sr) err = 2;
      if (err) {
        errs[i] = err;
        memset(row, 0, seg * sizeof(float));
        continue;
      }
      long t = (long)mono.size();
      if (t <= seg) {
        memcpy(row, mono.data(), t * sizeof(float));
        memset(row + t, 0, (seg - t) * sizeof(float));
      } else {
        long start = (long)(fracs[i] * (double)(t - seg + 1));
        if (start < 0) start = 0;
        if (start > t - seg) start = t - seg;
        memcpy(row, mono.data() + start, seg * sizeof(float));
      }
      errs[i] = 0;
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  if (nt > n) nt = n;
  std::vector<std::thread> threads;
  for (int k = 1; k < nt; k++) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // extern "C"
