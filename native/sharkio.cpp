// sharkio — native FASTQ parse + 2-bit-code encode loader.
//
// The reference's ingestion hot path is native (Rust, io.rs:271-361 +
// encoding.rs); this is this build's equivalent: a C++ loader that
// streams FASTQ (plain or gzip via zlib), validates records, and
// encodes bases directly into the fixed-width uint8 code batches the
// device encoder consumes (A/C/G/T -> 0..3, N -> 4, pad -> 5).
//
// Exposed as a C ABI consumed through ctypes (sharkmer_tpu/io/native.py).
// Validation semantics mirror the python reader (io/fastq.py), which
// stays as the permanent cross-check implementation.

#include <zlib.h>

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr unsigned char CODE_N = 4;
constexpr unsigned char CODE_PAD = 5;
constexpr unsigned char CODE_BAD = 255;

struct CodeLut {
    unsigned char table[256];
    CodeLut() {
        memset(table, CODE_BAD, sizeof(table));
        table['A'] = 0;
        table['C'] = 1;
        table['G'] = 2;
        table['T'] = 3;
        table['N'] = CODE_N;
    }
};
const CodeLut kLut;

}  // namespace

struct ShkReader {
    gzFile gz = nullptr;
    std::string error;
    std::string pending_seq;  // overlong read carried to the next batch
    bool pending_valid = false;
    long record_index = 0;  // global record counter (validation cadence)
    bool eof = false;

    // line buffer
    std::vector<char> buf;

    bool read_line(std::string* out) {
        out->clear();
        char chunk[4096];
        for (;;) {
            if (gzgets(gz, chunk, sizeof(chunk)) == nullptr) {
                int errnum = 0;
                const char* msg = gzerror(gz, &errnum);
                if (errnum != Z_OK && errnum != Z_STREAM_END) {
                    error = std::string("I/O error: ") + (msg ? msg : "unknown");
                    return false;
                }
                return !out->empty();
            }
            out->append(chunk);
            if (!out->empty() && out->back() == '\n') {
                out->pop_back();
                if (!out->empty() && out->back() == '\r') out->pop_back();
                return true;
            }
        }
    }
};

extern "C" {

ShkReader* shk_open(const char* path) {
    ShkReader* r = new ShkReader();
    // gzopen transparently reads both gzip and plain files
    r->gz = (strcmp(path, "-") == 0) ? gzdopen(0, "rb") : gzopen(path, "rb");
    if (r->gz == nullptr) {
        delete r;
        return nullptr;
    }
    gzbuffer(r->gz, 1 << 20);
    return r;
}

void shk_close(ShkReader* r) {
    if (r == nullptr) return;
    if (r->gz != nullptr) gzclose(r->gz);
    delete r;
}

const char* shk_error(ShkReader* r) { return r->error.c_str(); }

// Read up to max_reads FASTQ records, encoding sequences into
// out_codes[max_reads][width] (row-major) with CODE_PAD fill.
// seq_lens[i] receives the raw sequence length (incl. N).
// Returns:
//   >= 0  number of reads produced (0 at EOF)
//   -1    format / I/O error (see shk_error)
//   -2    a read longer than `width` was encountered; it is buffered,
//         the batch up to that point is in out_codes (count via
//         *n_out), and the caller should retry with width >=
//         *required_width.
long shk_read_batch(ShkReader* r, unsigned char* out_codes, long max_reads,
                    long width, long* seq_lens, long validate_every,
                    long* n_out, long* required_width) {
    *n_out = 0;
    *required_width = 0;
    if (r->eof && !r->pending_valid) return 0;

    std::string header, seq, sep, qual;
    long n = 0;
    while (n < max_reads) {
        if (r->pending_valid) {
            seq = std::move(r->pending_seq);
            r->pending_valid = false;
        } else {
            if (!r->read_line(&header)) {
                if (!r->error.empty()) return -1;
                r->eof = true;
                break;
            }
            // fail fast on FASTA before demanding 4 lines
            if (r->record_index == 0 && !header.empty() && header[0] == '>') {
                r->error =
                    "Input appears to be FASTA format, not FASTQ (record 1 "
                    "starts with '>'). sharkmer requires FASTQ input with "
                    "quality scores.";
                return -1;
            }
            if (!r->read_line(&seq)) {
                r->error = "Truncated FASTQ record at record " +
                           std::to_string(r->record_index + 1) +
                           ": missing sequence line";
                return -1;
            }
            if (!r->read_line(&sep)) {
                r->error = "Truncated FASTQ record at record " +
                           std::to_string(r->record_index + 1) +
                           ": missing separator line";
                return -1;
            }
            if (!r->read_line(&qual)) {
                r->error = "Truncated FASTQ record at record " +
                           std::to_string(r->record_index + 1) +
                           ": missing quality line";
                return -1;
            }
            bool validate = r->record_index == 0 ||
                            (validate_every > 0 &&
                             r->record_index % validate_every == 0);
            if (validate) {
                if (!header.empty() && header[0] == '>') {
                    r->error =
                        "Input appears to be FASTA format, not FASTQ (record " +
                        std::to_string(r->record_index + 1) +
                        " starts with '>'). sharkmer requires FASTQ input "
                        "with quality scores.";
                    return -1;
                }
                if (header.empty() || header[0] != '@') {
                    r->error = "FASTQ record " +
                               std::to_string(r->record_index + 1) +
                               " has invalid header (expected '@')";
                    return -1;
                }
                if (sep.empty() || sep[0] != '+') {
                    r->error = "FASTQ record " +
                               std::to_string(r->record_index + 1) +
                               " has invalid separator line (expected '+')";
                    return -1;
                }
                if (qual.size() != seq.size()) {
                    r->error = "FASTQ record " +
                               std::to_string(r->record_index + 1) +
                               " has mismatched sequence (" +
                               std::to_string(seq.size()) + ") and quality (" +
                               std::to_string(qual.size()) + ") lengths";
                    return -1;
                }
            }
            r->record_index++;
        }

        if ((long)seq.size() > width) {
            r->pending_seq = std::move(seq);
            r->pending_valid = true;
            *required_width = (long)r->pending_seq.size();
            *n_out = n;
            return -2;
        }

        unsigned char* row = out_codes + n * width;
        long i = 0;
        for (; i < (long)seq.size(); i++) {
            unsigned char c = kLut.table[(unsigned char)seq[i]];
            if (c == CODE_BAD) {
                r->error = std::string("Invalid character '") + seq[i] +
                           "' in sequence. Only ACGTN allowed.";
                return -1;
            }
            row[i] = c;
        }
        for (; i < width; i++) row[i] = CODE_PAD;
        seq_lens[n] = (long)seq.size();
        n++;
    }
    *n_out = n;
    return n;
}

}  // extern "C"
