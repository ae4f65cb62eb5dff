// Pooled host storage manager.
//
// The port's copy of mxnet_tpu's native/src/storage.h (upstream:
// src/storage/storage.cc, pooled_storage_manager.h): a pool of
// 64-byte-aligned host staging buffers with the reference's pow2
// rounding, and POSIX-shm segments that DataLoader workers can pass
// batches through without pickling (cpu_shared_storage_manager.h
// analog).  Device memory is torch's.
#ifndef MXNET_TPU_STORAGE_H_
#define MXNET_TPU_STORAGE_H_

#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace mxnet_tpu {

class PooledStorage {
 public:
  static PooledStorage* Get();

  void* Alloc(size_t size);
  void Free(void* ptr);
  // Release all cached free blocks back to the OS.
  void ReleaseAll();
  void Stats(uint64_t* allocated, uint64_t* pooled, uint64_t* num_allocs);

 private:
  PooledStorage() = default;
  static size_t RoundSize(size_t size);

  std::mutex mu_;
  std::map<void*, size_t> live_;                    // ptr → rounded size
  std::map<size_t, std::vector<void*>> free_pool_;  // rounded size → blocks
  uint64_t bytes_live_ = 0, bytes_pooled_ = 0, num_allocs_ = 0;
};

// POSIX shm segment (named) for DataLoader worker IPC.
class ShmSegment {
 public:
  // create=true: O_CREAT|O_EXCL with the given size; else attach existing.
  ShmSegment(const std::string& name, size_t size, bool create);
  ~ShmSegment();
  void* data() const { return data_; }
  size_t size() const { return size_; }
  const std::string& name() const { return name_; }
  // Unlink the name (segment lives until all mappings close).
  void Unlink();

 private:
  std::string name_;
  size_t size_ = 0;
  void* data_ = nullptr;
  int fd_ = -1;
};

}  // namespace mxnet_tpu

#endif  // MXNET_TPU_STORAGE_H_
