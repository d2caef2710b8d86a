// Native FASTA/FASTQ(.gz) parser of the PyTorch port (its own copy of
// kmer_hasher_tpu/io/native/fastx.cpp) — the data-loader role the reference
// fills with klib's kseq.h (vendored C, reference src/kseq.h:176-219). Re-designed
// rather than ported: one pass fills contiguous growable buffers (sequence
// bytes, qualities, record offsets, names) that the Python side wraps as
// NumPy arrays zero-copy, instead of kseq's per-record kstring churn.
//
// Grammar: '>' starts a FASTA record (sequence may span lines); '@' starts a
// FASTQ record (sequence lines until '+', then exactly seq_len quality
// bytes, possibly spanning lines). gzread handles both gzip and plain files.
//
// C ABI for ctypes; buffers owned by the result object, freed by
// fastx_free().

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#if __has_include(<zlib.h>)
#include <zlib.h>
#else
// No zlib header on this machine (the library itself is there wherever
// Python's zlib module loads): the few entries used here, as zlib.h declares
// them on an LP64 system. io/native.py then names the library by file.
extern "C" {
typedef struct gzFile_s* gzFile;
gzFile gzopen(const char* path, const char* mode);
int gzread(gzFile file, void* buf, unsigned len);
int gzclose(gzFile file);
long gzseek(gzFile file, long offset, int whence);
long gztell(gzFile file);
}
#endif

namespace {

struct Buf {
  uint8_t* data = nullptr;
  int64_t len = 0;
  int64_t cap = 0;
  void reserve(int64_t need) {
    if (need <= cap) return;
    int64_t ncap = cap ? cap : 1 << 16;
    while (ncap < need) ncap *= 2;
    uint8_t* ndata = static_cast<uint8_t*>(realloc(data, ncap));
    if (!ndata) abort();  // allocation failure: no recovery path here
    data = ndata;
    cap = ncap;
  }
  void append(const uint8_t* p, int64_t n) {
    reserve(len + n);
    memcpy(data + len, p, n);
    len += n;
  }
  void push(uint8_t c) {
    reserve(len + 1);
    data[len++] = c;
  }
};

// Buffered gz reader with line-oriented access.
class Reader {
 public:
  explicit Reader(const char* path) : gz_(gzopen(path, "rb")) {}
  ~Reader() {
    if (gz_) gzclose(gz_);
  }
  bool ok() const { return gz_ != nullptr; }
  // true if a gzread returned a hard error (corrupt stream), as opposed to
  // EOF — callers must not treat the truncated result as a complete parse.
  bool io_error() const { return io_error_; }

  // Offset (in the uncompressed stream) of the next byte get()/peek()
  // would return. base_ tracks gztell() after the last fill, i.e. the
  // offset just past the buffered chunk.
  int64_t stream_pos() const { return base_ - (avail_ - pos_); }
  // Reposition to an absolute uncompressed offset. Plain files seek raw
  // (fast); gzip members decompress forward (callers gate range reads to
  // plain files). Discards the buffer.
  bool seek(int64_t off) {
    if (!gz_ || gzseek(gz_, off, SEEK_SET) < 0) return false;
    base_ = off;
    pos_ = avail_ = 0;
    return true;
  }
  // Records starting at-or-after this offset belong to the next range
  // reader; parse loops stop there (-1 = no limit).
  void set_end(int64_t end) { end_ = end; }
  bool past_end() const { return end_ >= 0 && stream_pos() >= end_; }

  int peek() {
    if (pos_ >= avail_ && !fill()) return -1;
    return buf_[pos_];
  }
  int get() {
    if (pos_ >= avail_ && !fill()) return -1;
    return buf_[pos_++];
  }
  // append the rest of the current line (no terminator) to out; consume the
  // newline. Returns false at EOF with nothing read.
  bool read_line(Buf& out) {
    bool any = false;
    while (true) {
      if (pos_ >= avail_ && !fill()) return any;
      int64_t start = pos_;
      while (pos_ < avail_ && buf_[pos_] != '\n') ++pos_;
      int64_t n = pos_ - start;
      if (n > 0 && pos_ < avail_) {  // strip \r before \n
        if (buf_[pos_ - 1] == '\r') --n;
      }
      out.append(buf_ + start, n);
      any = any || n > 0;
      if (pos_ < avail_) {
        ++pos_;  // consume '\n'
        return true;
      }
      // buffer exhausted mid-line: handle possible trailing \r at split
      if (n > 0 && out.len > 0 && out.data[out.len - 1] == '\r') --out.len;
      any = true;
    }
  }
  void skip_line() {
    while (true) {
      if (pos_ >= avail_ && !fill()) return;
      while (pos_ < avail_ && buf_[pos_] != '\n') ++pos_;
      if (pos_ < avail_) {
        ++pos_;
        return;
      }
    }
  }

 private:
  bool fill() {
    if (!gz_) return false;
    int n = gzread(gz_, buf_, sizeof(buf_));
    if (n < 0) {  // hard error (e.g. corrupt gzip), not EOF
      io_error_ = true;
      return false;
    }
    if (n == 0) return false;
    base_ = gztell(gz_);
    avail_ = n;
    pos_ = 0;
    return true;
  }
  gzFile gz_;
  uint8_t buf_[1 << 16];
  int64_t pos_ = 0;
  int64_t avail_ = 0;
  int64_t base_ = 0;
  int64_t end_ = -1;
  bool io_error_ = false;
};

}  // namespace

extern "C" {

struct FastxResult {
  uint8_t* seq;
  uint8_t* qual;
  int64_t* offsets;  // n_records + 1
  uint8_t* qual_present;
  char* names;  // '\n'-joined
  int64_t n_records;
  int64_t names_len;
  int error;  // 0 ok, 1 open failed, 2 parse error, 3 read error (corrupt)
};

struct FastxReaderHandle;  // opaque streaming handle

static void parse_records(Reader& rd, FastxResult* res,
                          int64_t max_records) {
  Buf seq, qual, names;
  std::vector<int64_t> offsets;
  std::vector<uint8_t> qpres;
  offsets.push_back(0);

  while (max_records < 0 ||
         static_cast<int64_t>(qpres.size()) < max_records) {
    int c = rd.peek();
    if (c < 0) break;
    // range readers stop at the first record that STARTS at-or-after the
    // range end — that record belongs to the next host's byte range
    // (checked before leader validation: a range pinned empty must not
    // report a parse error for content it does not own)
    if (rd.past_end()) break;
    if (c != '>' && c != '@') {
      // tolerate blank separator lines; anything else is a parse error
      if (c == '\n' || c == '\r') {
        rd.skip_line();
        continue;
      }
      res->error = 2;
      break;
    }
    rd.get();
    // name = first word of header
    Buf header;
    rd.read_line(header);
    int64_t w = 0;
    while (w < header.len && header.data[w] != ' ' && header.data[w] != '\t')
      ++w;
    names.append(header.data, w);
    names.push('\n');
    free(header.data);

    int64_t rec_start = seq.len;
    if (c == '>') {
      while (true) {
        int p = rd.peek();
        if (p < 0 || p == '>' || p == '@') break;
        rd.read_line(seq);
      }
      int64_t n = seq.len - rec_start;
      qual.reserve(qual.len + n);
      memset(qual.data + qual.len, 0, n);
      qual.len += n;
      qpres.push_back(0);
    } else {
      while (true) {
        int p = rd.peek();
        if (p < 0 || p == '+') break;
        rd.read_line(seq);
      }
      rd.skip_line();  // the '+' line
      int64_t need = seq.len - rec_start;
      int64_t got_start = qual.len;
      while (qual.len - got_start < need) {
        int64_t before = qual.len;
        if (!rd.read_line(qual)) break;
        if (qual.len == before && rd.peek() < 0) break;
      }
      if (qual.len - got_start != need) {
        res->error = 2;
        break;
      }
      qpres.push_back(1);
    }
    offsets.push_back(seq.len);
  }
  if (rd.io_error() && res->error == 0) res->error = 3;

  res->seq = seq.data;
  res->qual = qual.data;
  res->n_records = static_cast<int64_t>(qpres.size());
  res->offsets =
      static_cast<int64_t*>(malloc(sizeof(int64_t) * offsets.size()));
  memcpy(res->offsets, offsets.data(), sizeof(int64_t) * offsets.size());
  res->qual_present = static_cast<uint8_t*>(malloc(qpres.size() ? qpres.size() : 1));
  if (!qpres.empty())
    memcpy(res->qual_present, qpres.data(), qpres.size());
  res->names = reinterpret_cast<char*>(names.data);
  res->names_len = names.len;
}

FastxResult* fastx_read(const char* path, int64_t max_records) {
  auto* res = static_cast<FastxResult*>(calloc(1, sizeof(FastxResult)));
  Reader rd(path);
  if (!rd.ok()) {
    res->error = 1;
    return res;
  }
  parse_records(rd, res, max_records);
  return res;
}

// Streaming handle: parse the file in bounded batches with constant
// memory (the whole-file load above is unusable for multi-hundred-GB
// read corpora and prevents IO/compute overlap).
FastxReaderHandle* fastx_open(const char* path) {
  auto* rd = new Reader(path);
  if (!rd->ok()) {
    delete rd;
    return nullptr;
  }
  return reinterpret_cast<FastxReaderHandle*>(rd);
}

// -- byte-range reading (multi-host input slicing) --------------------------
//
// Each host owns the records whose FIRST byte falls in [start, end): the
// opener seeks near start, re-synchronises to the next record boundary, and
// the parse loop stops at the first record starting at-or-after end. The
// union over hosts of [size*p/n, size*(p+1)/n) ranges is an exact partition
// of the records. Plain (non-gzip) files only — a gzip stream cannot be
// byte-addressed without decompressing the prefix, so callers gate on the
// magic bytes. This replaces the reference's redundant full-file read per
// worker (src/kmer_reader.h:32-34) with true input data parallelism.

namespace {

// Read one full line (no terminator) starting at the reader's position.
static bool scan_line(Reader& rd, std::string& out) {
  out.clear();
  int c = rd.get();
  if (c < 0) return false;
  while (c >= 0 && c != '\n') {
    out.push_back(static_cast<char>(c));
    c = rd.get();
  }
  if (!out.empty() && out.back() == '\r') out.pop_back();
  return true;
}

// First record boundary at-or-after the current position (which sits at a
// line start), before offset `end`. fmt is the file's leading byte ('>'
// FASTA / '@' FASTQ). FASTA: a '>' line start is unambiguous (no quality
// lines exist). FASTQ: '@' (and '+') are legal QUALITY bytes, so a '@' line
// start is verified against two consecutive 4-line records (header /
// sequence / '+' separator / equal-length quality) — the standard
// re-synchronisation used by parallel FASTQ splitters. Multi-line FASTQ is
// not supported in range mode (callers fall back to lockstep streaming).
static int64_t find_boundary(Reader& rd, int fmt, int64_t end) {
  if (fmt == '>') {
    while (true) {
      int64_t pos = rd.stream_pos();
      if (end >= 0 && pos >= end) return -1;
      int c = rd.peek();
      if (c < 0) return -1;
      if (c == '>') return pos;
      rd.skip_line();
    }
  }
  // FASTQ: sliding window of (offset, line) with 8-line lookahead
  std::vector<std::pair<int64_t, std::string>> win;
  auto have = [&](size_t idx) -> bool {
    while (win.size() <= idx) {
      int64_t pos = rd.stream_pos();
      std::string s;
      if (!scan_line(rd, s)) return false;
      win.emplace_back(pos, std::move(s));
    }
    return true;
  };
  auto starts = [&](size_t idx, char c) -> bool {
    return !win[idx].second.empty() && win[idx].second[0] == c;
  };
  for (size_t i = 0;; ++i) {
    if (!have(i)) return -1;
    if (end >= 0 && win[i].first >= end) return -1;
    if (!starts(i, '@')) continue;
    bool ok;
    if (have(i + 3)) {
      ok = starts(i + 2, '+') &&
           win[i + 3].second.size() == win[i + 1].second.size();
      if (ok && have(i + 7)) {  // second record confirms
        ok = starts(i + 4, '@') && starts(i + 6, '+') &&
             win[i + 7].second.size() == win[i + 5].second.size();
      } else if (ok && have(i + 4)) {  // exactly one record + header left
        ok = starts(i + 4, '@');
      }
    } else {
      // EOF within 4 lines: accept a truncated final record shape
      ok = have(i + 2) && starts(i + 2, '+');
    }
    if (ok) return win[i].first;
  }
}

}  // namespace

// Open a streaming handle over records starting in [start, end).
FastxReaderHandle* fastx_open_range(const char* path, int64_t start,
                                    int64_t end) {
  int fmt = 0;
  {
    Reader probe(path);
    if (!probe.ok()) return nullptr;  // open failure -> caller raises
    fmt = probe.peek();
  }
  auto* rd = new Reader(path);
  if (!rd->ok()) {
    delete rd;
    return nullptr;
  }
  if (fmt != '>' && fmt != '@') {
    // empty file -> empty stream (the non-range path yields no records);
    // junk leader -> host 0 parses from byte 0 and reports the parse
    // error exactly like the non-range path, other hosts go empty
    rd->set_end(start > 0 ? 0 : end);
    return reinterpret_cast<FastxReaderHandle*>(rd);
  }
  int64_t boundary = 0;
  if (start > 0) {
    // seek to start-1 and drop one line: if start-1 is a '\n' this lands
    // exactly on start, else it lands at the first line start after
    // start — so a record beginning exactly at `start` is still OURS
    if (!rd->seek(start - 1)) {
      delete rd;
      return nullptr;
    }
    std::string partial;
    scan_line(*rd, partial);
    boundary = find_boundary(*rd, fmt, end);
    if (boundary < 0) {  // no record starts in this range: empty stream
      rd->set_end(0);
      rd->seek(0);
      return reinterpret_cast<FastxReaderHandle*>(rd);
    }
    if (!rd->seek(boundary)) {
      delete rd;
      return nullptr;
    }
  }
  rd->set_end(end);
  return reinterpret_cast<FastxReaderHandle*>(rd);
}

// Uncompressed-stream offset of the next unread byte (parse progress).
int64_t fastx_handle_tell(FastxReaderHandle* h) {
  return reinterpret_cast<Reader*>(h)->stream_pos();
}

FastxResult* fastx_read_batch(FastxReaderHandle* h, int64_t max_records) {
  auto* res = static_cast<FastxResult*>(calloc(1, sizeof(FastxResult)));
  parse_records(*reinterpret_cast<Reader*>(h), res, max_records);
  return res;
}

void fastx_close(FastxReaderHandle* h) {
  delete reinterpret_cast<Reader*>(h);
}

// Fill caller-allocated padded planes from records [i, j) of res: row r of
// the output holds record i+r left-justified, 'N'/0-padded to Lp columns
// (rows beyond j-i are fully padded). This replaces the NumPy fancy-index
// scatter the Python side otherwise performs per batch — per-row memcpy is
// a single pass at memory bandwidth, which matters on throttled hosts where
// building the int64 index vectors dominates the input pipeline.
// seq_out/qual_out: row-major (Bp, Lp) u8. len_out: i32[Bp]. qpres_out:
// u8[Bp]. Records longer than Lp are truncated (callers size Lp >= max len).
void fastx_fill_padded(const FastxResult* res, int64_t i, int64_t j,
                       int64_t Bp, int64_t Lp, uint8_t* seq_out,
                       uint8_t* qual_out, int32_t* len_out,
                       uint8_t* qpres_out) {
  int64_t B = j - i;
  for (int64_t r = 0; r < Bp; ++r) {
    uint8_t* srow = seq_out + r * Lp;
    uint8_t* qrow = qual_out + r * Lp;
    int64_t n = 0;
    if (r < B) {
      int64_t a = res->offsets[i + r];
      n = res->offsets[i + r + 1] - a;
      if (n > Lp) n = Lp;
      memcpy(srow, res->seq + a, n);
      memcpy(qrow, res->qual + a, n);
    }
    memset(srow + n, 'N', Lp - n);
    memset(qrow + n, 0, Lp - n);
    len_out[r] = r < B ? static_cast<int32_t>(n) : 0;
    qpres_out[r] = r < B ? res->qual_present[i + r] : 0;
  }
}

void fastx_free(FastxResult* res) {
  if (!res) return;
  free(res->seq);
  free(res->qual);
  free(res->offsets);
  free(res->qual_present);
  free(res->names);
  free(res);
}

}  // extern "C"
