// See storage.h for design notes.
#include "storage.h"

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstdlib>
#include <stdexcept>

namespace mxnet_tpu {

PooledStorage* PooledStorage::Get() {
  static PooledStorage inst;
  return &inst;
}

size_t PooledStorage::RoundSize(size_t size) {
  // Reference pool policy (GPUPooledRoundedStorageManager): round small
  // sizes to 128B lines, larger ones to the next power of two — bounds
  // fragmentation while keeping reuse hit-rate high.
  if (size <= 128) return 128;
  if (size >= (1u << 20)) {
    // >=1MB: round to 1MB granularity (pow2 would waste up to 2x)
    return (size + (1u << 20) - 1) & ~((static_cast<size_t>(1) << 20) - 1);
  }
  size_t r = 128;
  while (r < size) r <<= 1;
  return r;
}

void* PooledStorage::Alloc(size_t size) {
  size_t rounded = RoundSize(size);
  {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = free_pool_.find(rounded);
    if (it != free_pool_.end() && !it->second.empty()) {
      void* p = it->second.back();
      it->second.pop_back();
      bytes_pooled_ -= rounded;
      bytes_live_ += rounded;
      live_[p] = rounded;
      num_allocs_++;
      return p;
    }
  }
  void* p = nullptr;
  // 64B alignment: cache lines + efficient DMA staging for host-to-device copies
  if (posix_memalign(&p, 64, rounded) != 0)
    throw std::runtime_error("PooledStorage: out of memory");
  std::lock_guard<std::mutex> lk(mu_);
  live_[p] = rounded;
  bytes_live_ += rounded;
  num_allocs_++;
  return p;
}

void PooledStorage::Free(void* ptr) {
  std::lock_guard<std::mutex> lk(mu_);
  auto it = live_.find(ptr);
  if (it == live_.end()) throw std::runtime_error("PooledStorage: bad free");
  size_t rounded = it->second;
  live_.erase(it);
  bytes_live_ -= rounded;
  bytes_pooled_ += rounded;
  free_pool_[rounded].push_back(ptr);
}

void PooledStorage::ReleaseAll() {
  std::lock_guard<std::mutex> lk(mu_);
  for (auto& kv : free_pool_)
    for (void* p : kv.second) std::free(p);
  free_pool_.clear();
  bytes_pooled_ = 0;
}

void PooledStorage::Stats(uint64_t* allocated, uint64_t* pooled,
                          uint64_t* num_allocs) {
  std::lock_guard<std::mutex> lk(mu_);
  *allocated = bytes_live_;
  *pooled = bytes_pooled_;
  *num_allocs = num_allocs_;
}

ShmSegment::ShmSegment(const std::string& name, size_t size, bool create)
    : name_(name), size_(size) {
  int flags = create ? (O_RDWR | O_CREAT | O_EXCL) : O_RDWR;
  fd_ = shm_open(name.c_str(), flags, 0600);
  if (fd_ < 0) throw std::runtime_error("shm_open failed for " + name);
  if (create && ftruncate(fd_, static_cast<off_t>(size)) != 0) {
    shm_unlink(name.c_str());
    throw std::runtime_error("ftruncate failed for " + name);
  }
  if (!create) {
    struct stat st;
    if (fstat(fd_, &st) == 0) size_ = static_cast<size_t>(st.st_size);
  }
  data_ = mmap(nullptr, size_, PROT_READ | PROT_WRITE, MAP_SHARED, fd_, 0);
  if (data_ == MAP_FAILED) {
    if (create) shm_unlink(name.c_str());
    throw std::runtime_error("mmap failed for " + name);
  }
}

ShmSegment::~ShmSegment() {
  if (data_ && data_ != MAP_FAILED) munmap(data_, size_);
  if (fd_ >= 0) close(fd_);
}

void ShmSegment::Unlink() { shm_unlink(name_.c_str()); }

}  // namespace mxnet_tpu
