// RecordIO — wire-compatible binary record container.
//
// The port's copy of mxnet_tpu's native/src/recordio.h (upstream:
// dmlc-core's include/dmlc/recordio.h).  Format: [kMagic u32]
// [cflag:3|len:29 u32][payload][pad to 4B]; payloads containing the magic
// are split with continuation flags 1/2/3.  The .idx sidecar maps integer
// keys to byte offsets ("key\toffset\n" lines).
#ifndef MXNET_TPU_RECORDIO_H_
#define MXNET_TPU_RECORDIO_H_

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <utility>
#include <vector>
#include <stdexcept>

namespace mxnet_tpu {

static const uint32_t kRecMagic = 0xced7230a;

class RecordIOReader {
 public:
  explicit RecordIOReader(const std::string& path) {
    fp_ = std::fopen(path.c_str(), "rb");
    if (!fp_) throw std::runtime_error("RecordIOReader: cannot open " + path);
  }
  ~RecordIOReader() { if (fp_) std::fclose(fp_); }

  // Read next logical record into out.  Returns false at EOF.
  bool ReadRecord(std::string* out) {
    out->clear();
    bool first = true;
    while (true) {
      uint32_t header[2];
      size_t n = std::fread(header, 1, 8, fp_);
      if (n < 8) {
        if (first) return false;
        throw std::runtime_error("RecordIO: truncated record");
      }
      if (header[0] != kRecMagic)
        throw std::runtime_error("RecordIO: bad magic");
      uint32_t cflag = header[1] >> 29;
      uint32_t len = header[1] & ((1u << 29) - 1);
      size_t pos = out->size();
      if (!first) {
        out->append(reinterpret_cast<const char*>(&kRecMagic), 4);
        pos += 4;
      }
      out->resize(pos + len);
      if (len && std::fread(&(*out)[pos], 1, len, fp_) != len)
        throw std::runtime_error("RecordIO: truncated payload");
      size_t pad = (4 - len % 4) % 4;
      if (pad) std::fseek(fp_, static_cast<long>(pad), SEEK_CUR);
      first = false;
      if (cflag == 0 || cflag == 3) return true;
    }
  }

  void Seek(uint64_t offset) { std::fseek(fp_, static_cast<long>(offset), SEEK_SET); }
  uint64_t Tell() const { return static_cast<uint64_t>(std::ftell(fp_)); }

 private:
  std::FILE* fp_ = nullptr;
};

class RecordIOWriter {
 public:
  explicit RecordIOWriter(const std::string& path) {
    fp_ = std::fopen(path.c_str(), "wb");
    if (!fp_) throw std::runtime_error("RecordIOWriter: cannot open " + path);
  }
  ~RecordIOWriter() { if (fp_) std::fclose(fp_); }

  void WriteRecord(const char* data, size_t size) {
    // split payload on embedded magic (continuation encoding)
    std::vector<std::pair<const char*, size_t>> chunks;
    size_t start = 0;
    for (size_t i = 0; i + 4 <= size; ) {
      if (memcmp(data + i, &kRecMagic, 4) == 0) {
        chunks.emplace_back(data + start, i - start);
        i += 4;
        start = i;
      } else {
        ++i;
      }
    }
    chunks.emplace_back(data + start, size - start);
    size_t n = chunks.size();
    for (size_t i = 0; i < n; ++i) {
      uint32_t cflag = (n == 1) ? 0 : (i == 0 ? 1 : (i == n - 1 ? 3 : 2));
      uint32_t len = static_cast<uint32_t>(chunks[i].second);
      uint32_t lrec = (cflag << 29) | len;
      std::fwrite(&kRecMagic, 1, 4, fp_);
      std::fwrite(&lrec, 1, 4, fp_);
      if (len) std::fwrite(chunks[i].first, 1, len, fp_);
      static const char zeros[4] = {0, 0, 0, 0};
      size_t pad = (4 - len % 4) % 4;
      if (pad) std::fwrite(zeros, 1, pad, fp_);
    }
  }

  uint64_t Tell() const { return static_cast<uint64_t>(std::ftell(fp_)); }
  void Flush() { std::fflush(fp_); }

 private:
  std::FILE* fp_ = nullptr;
};

// .idx sidecar: "<key>\t<offset>" per line.
inline void LoadIndex(const std::string& idx_path,
                      std::vector<std::pair<int64_t, uint64_t>>* out) {
  std::FILE* f = std::fopen(idx_path.c_str(), "r");
  if (!f) throw std::runtime_error("cannot open index " + idx_path);
  long long key, off;
  while (std::fscanf(f, "%lld\t%lld", &key, &off) == 2)
    out->emplace_back(static_cast<int64_t>(key), static_cast<uint64_t>(off));
  std::fclose(f);
}

}  // namespace mxnet_tpu

#endif  // MXNET_TPU_RECORDIO_H_
