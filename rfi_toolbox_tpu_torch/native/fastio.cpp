// fastio: threaded, double-buffered .npy batch-file reader (the port's copy
// of rfi_toolbox_tpu/native/fastio.cpp).
//
// The training input pipeline's host side is file reads feeding the
// host-to-device copies of each minibatch. The reference delegates this to torch
// DataLoader worker *processes* (pickle round trips per batch); here a
// small native runtime does it properly: a thread pool reads .npy files
// ahead of the consumer into a bounded in-order queue, so disk latency
// overlaps host->device transfer and device compute.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).
// Supports .npy format versions 1.0/2.0, C-contiguous arrays.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Buffer {
  void* data = nullptr;
  long long nbytes = 0;
  char dtype[16] = {0};
  long long shape[8] = {0};
  int ndim = 0;
  bool ok = false;
};

// Parse a .npy header; on success positions *offset at the data start.
bool parse_npy_header(FILE* f, Buffer* out, long long* offset) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
    *offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
    *offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;

  // descr
  size_t dpos = header.find("'descr'");
  if (dpos == std::string::npos) return false;
  size_t q1 = header.find('\'', dpos + 7);
  size_t q2 = header.find('\'', q1 + 1);
  std::string descr = header.substr(q1 + 1, q2 - q1 - 1);
  if (descr.size() >= sizeof(out->dtype)) return false;
  strncpy(out->dtype, descr.c_str(), sizeof(out->dtype) - 1);

  // fortran_order must be False (C-contiguous)
  if (header.find("'fortran_order': True") != std::string::npos) return false;

  // shape tuple
  size_t spos = header.find("'shape'");
  if (spos == std::string::npos) return false;
  size_t p1 = header.find('(', spos);
  size_t p2 = header.find(')', p1);
  std::string shape_s = header.substr(p1 + 1, p2 - p1 - 1);
  out->ndim = 0;
  const char* s = shape_s.c_str();
  while (*s && out->ndim < 8) {
    while (*s == ' ' || *s == ',') s++;
    if (!*s) break;
    out->shape[out->ndim++] = strtoll(s, const_cast<char**>(&s), 10);
  }
  // element size from descr like '<f4', '|u1', '<c8'
  long long itemsize = strtoll(descr.c_str() + 2, nullptr, 10);
  if (itemsize <= 0) return false;
  long long n = 1;
  for (int i = 0; i < out->ndim; i++) n *= out->shape[i];
  out->nbytes = n * itemsize;
  return true;
}

bool read_npy(const std::string& path, Buffer* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  long long offset = 0;
  if (!parse_npy_header(f, out, &offset)) {
    fclose(f);
    return false;
  }
  if (fseek(f, (long)offset, SEEK_SET) != 0) {
    fclose(f);
    return false;
  }
  out->data = malloc((size_t)out->nbytes);
  if (!out->data) {
    fclose(f);
    return false;
  }
  bool ok = fread(out->data, 1, (size_t)out->nbytes, f) ==
            (size_t)out->nbytes;
  fclose(f);
  if (!ok) {
    free(out->data);
    out->data = nullptr;
    return false;
  }
  out->ok = true;
  return true;
}

struct Reader {
  std::vector<std::string> paths;
  std::map<int, Buffer> ready;       // seq -> buffer (in-order handoff)
  std::atomic<int> next_job{0};
  int next_out = 0;
  int queue_depth;
  std::mutex mu;
  std::condition_variable cv_space, cv_ready;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      int job = next_job.fetch_add(1);
      if (job >= (int)paths.size() || stop.load()) return;
      Buffer buf;
      read_npy(paths[job], &buf);  // buf.ok = false on failure
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() || (int)ready.size() < queue_depth ||
               job < next_out + queue_depth;
      });
      if (stop.load()) {
        if (buf.data) free(buf.data);
        return;
      }
      ready.emplace(job, buf);
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* fastio_open(const char** paths, int n_files, int n_threads,
                  int queue_depth) {
  auto* r = new Reader();
  for (int i = 0; i < n_files; i++) r->paths.emplace_back(paths[i]);
  r->queue_depth = queue_depth > 0 ? queue_depth : 2;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; i++)
    r->workers.emplace_back(&Reader::worker, r);
  return r;
}

// Blocks until the next file (in order) is ready. Returns the sequence
// index, or -1 at end of stream, or -2 on read error. The buffer is
// owned by the caller; free with fastio_free.
int fastio_next(void* handle, void** data, long long* nbytes, char* dtype,
                long long* shape, int* ndim) {
  auto* r = static_cast<Reader*>(handle);
  if (r->next_out >= (int)r->paths.size()) return -1;
  std::unique_lock<std::mutex> lk(r->mu);
  r->cv_ready.wait(lk, [&] { return r->ready.count(r->next_out) > 0; });
  Buffer buf = r->ready[r->next_out];
  r->ready.erase(r->next_out);
  int seq = r->next_out++;
  r->cv_space.notify_all();
  lk.unlock();
  if (!buf.ok) return -2;
  *data = buf.data;
  *nbytes = buf.nbytes;
  memcpy(dtype, buf.dtype, 16);
  memcpy(shape, buf.shape, sizeof(buf.shape));
  *ndim = buf.ndim;
  return seq;
}

void fastio_free(void* data) { free(data); }

void fastio_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  r->stop.store(true);
  r->next_job.store(1 << 29);
  r->cv_space.notify_all();
  r->cv_ready.notify_all();
  for (auto& t : r->workers) t.join();
  for (auto& kv : r->ready)
    if (kv.second.data) free(kv.second.data);
  delete r;
}

}  // extern "C"
