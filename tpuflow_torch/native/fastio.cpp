// Native frame IO for tpuflow_torch: the $readmemh frame codec, the .bin
// loader that widens u8 pixels to float32, and a read-ahead thread that
// writes each frame into a buffer the caller gives it.
//
// A plain C interface, loaded with ctypes (tpuflow_torch/io/fastio.py).
// ctypes releases the interpreter lock around every call into this
// library, so file IO, parsing, widening and the blocking wait for the
// next frame all run without it. No function here touches a Python
// object.
//
// Return codes: 0 is success; a positive code is the errno of a failed
// open, read or write; the negative codes are below.

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <sys/stat.h>

namespace {

constexpr int kMalformed = -1;     // a .mem file with a character that is not hex
constexpr int kWrongSize = -2;     // a .bin file whose byte count is not the frame's
constexpr int kEnd = -3;           // the prefetcher has handed over every frame
constexpr int kNoBuffer = -4;      // next() with no buffer given and nothing ready

std::atomic<int> live_workers{0};

int hex_val(char c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return -1;
}

// Parses $readmemh text into bytes: two hex digits a byte, whitespace and
// //-comments skipped. False on any other character (such as X values).
bool decode_mem_text(const char* text, size_t len, std::vector<uint8_t>* out) {
  size_t i = 0;
  while (i < len) {
    char c = text[i];
    if (c == '/' && i + 1 < len && text[i + 1] == '/') {
      while (i < len && text[i] != '\n') i++;
      continue;
    }
    int hi = hex_val(c);
    if (hi >= 0) {
      if (i + 1 >= len) return false;
      int lo = hex_val(text[i + 1]);
      if (lo < 0) return false;
      out->push_back(static_cast<uint8_t>((hi << 4) | lo));
      i += 2;
      continue;
    }
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      i++;
      continue;
    }
    return false;
  }
  return true;
}

// A byte buffer that grows without zeroing what a read will overwrite.
struct Bytes {
  std::unique_ptr<char[]> data;
  size_t capacity = 0;
  size_t size = 0;

  void reserve(size_t n) {  // keeps the first `size` bytes
    if (n <= capacity) return;
    std::unique_ptr<char[]> grown(new char[n]);
    if (size) std::memcpy(grown.get(), data.get(), size);
    data = std::move(grown);
    capacity = n;
  }
};

// Reads a whole file, to its end (a pipe too); returns 0 or the errno of
// the failure.
int read_file(const char* path, Bytes* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return errno ? errno : EIO;
  // A regular file's size plus one byte, so one read reaches its end.
  struct stat st;
  bool regular = fstat(fileno(f), &st) == 0 && S_ISREG(st.st_mode);
  buf->size = 0;
  buf->reserve(regular ? static_cast<size_t>(st.st_size) + 1 : size_t{1} << 20);
  for (;;) {
    buf->size += std::fread(buf->data.get() + buf->size, 1, buf->capacity - buf->size, f);
    if (buf->size < buf->capacity) break;
    buf->reserve(buf->capacity * 2);
  }
  int err = std::ferror(f) ? (errno ? errno : EIO) : 0;
  std::fclose(f);
  return err;
}

// u8 -> float32 in blocks of a fixed count, which the compiler vectorizes
// at -O2 (a loop of unknown count it leaves scalar there).
void widen(const uint8_t* __restrict__ src, float* __restrict__ dst, int64_t n) {
  constexpr int64_t kBlock = 64;
  int64_t i = 0;
  for (; i + kBlock <= n; i += kBlock) {
    for (int64_t j = 0; j < kBlock; j++) dst[i + j] = static_cast<float>(src[i + j]);
  }
  for (; i < n; i++) dst[i] = static_cast<float>(src[i]);
}

// Reads a u8 frame of `pixels` bytes and widens it into `dst`.
int load_bin(const char* path, float* dst, int64_t pixels, Bytes* raw, int64_t* size) {
  int err = read_file(path, raw);
  if (err) return err;
  *size = static_cast<int64_t>(raw->size);
  if (*size != pixels) return kWrongSize;
  widen(reinterpret_cast<const uint8_t*>(raw->data.get()), dst, pixels);
  return 0;
}

// The read-ahead worker: reads paths in order, each into the oldest buffer
// the caller has given and not yet had back; a failure takes its frame's
// place in the order, so the frames read before it are handed over first.
struct Prefetcher {
  struct Ready {
    float* buffer;   // the frame, or null for a failure
    int code;        // 0, or the failure's code
    int64_t size;    // the file's byte count, for kWrongSize
  };

  std::vector<std::string> paths;
  int64_t pixels = 0;
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  std::deque<float*> free_buffers;
  std::deque<Ready> ready;
  size_t handed = 0;  // frames and failures taken by the consumer
  bool stop = false;
  bool failed = false;
  bool reading = false;  // the worker holds a buffer it has not handed over
  std::thread worker;

  void run() {
    Bytes raw;  // the file's bytes, reused frame to frame
    for (size_t i = 0; i < paths.size(); i++) {
      float* dst;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_free.wait(lock, [&] { return stop || !free_buffers.empty(); });
        if (stop) break;
        dst = free_buffers.front();
        free_buffers.pop_front();
        reading = true;
      }
      int64_t size = 0;
      int code = load_bin(paths[i].c_str(), dst, pixels, &raw, &size);
      std::lock_guard<std::mutex> lock(mu);
      reading = false;
      if (code != 0) {
        free_buffers.push_front(dst);
        ready.push_back({nullptr, code, size});
        cv_ready.notify_all();
        break;
      }
      ready.push_back({dst, 0, size});
      cv_ready.notify_all();
    }
    live_workers.fetch_sub(1);
  }
};

}  // namespace

extern "C" {

// Reads a $readmemh file; on success *out holds *count bytes, allocated
// here and released with tpuflow_io_free.
int tpuflow_io_decode_mem(const char* path, uint8_t** out, int64_t* count) {
  Bytes text;
  int err = read_file(path, &text);
  if (err) return err;
  std::vector<uint8_t> bytes;
  if (!decode_mem_text(text.data.get(), text.size, &bytes)) return kMalformed;
  *count = static_cast<int64_t>(bytes.size());
  *out = static_cast<uint8_t*>(std::malloc(bytes.size() ? bytes.size() : 1));
  if (!*out) return ENOMEM;
  std::memcpy(*out, bytes.data(), bytes.size());
  return 0;
}

void tpuflow_io_free(void* p) { std::free(p); }

// Writes `count` bytes as $readmemh text: two lowercase hex digits a line.
int tpuflow_io_encode_mem(const char* path, const uint8_t* data, int64_t count) {
  static const char digits[] = "0123456789abcdef";
  std::string out;
  out.reserve(static_cast<size_t>(count) * 3);
  for (int64_t i = 0; i < count; i++) {
    out.push_back(digits[data[i] >> 4]);
    out.push_back(digits[data[i] & 0xf]);
    out.push_back('\n');
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) return errno ? errno : EIO;
  bool ok = std::fwrite(out.data(), 1, out.size(), f) == out.size();
  int err = ok ? 0 : (errno ? errno : EIO);
  if (std::fclose(f) != 0 && !err) err = errno ? errno : EIO;
  return err;
}

// Reads a u8 frame of `pixels` bytes into float32 `dst`; *size gets the
// file's byte count (kWrongSize where it is not `pixels`).
int tpuflow_io_load_bin_f32(const char* path, float* dst, int64_t pixels, int64_t* size) {
  Bytes raw;
  return load_bin(path, dst, pixels, &raw, size);
}

// Starts a read-ahead thread over `n` paths of `pixels`-byte frames. It
// reads only into buffers given with tpuflow_io_prefetcher_give.
void* tpuflow_io_prefetcher_open(const char* const* paths, int n, int64_t pixels) {
  Prefetcher* p = new Prefetcher();
  for (int i = 0; i < n; i++) p->paths.emplace_back(paths[i]);
  p->pixels = pixels;
  live_workers.fetch_add(1);
  p->worker = std::thread([p] { p->run(); });
  return p;
}

// Gives the worker a buffer of `pixels` floats to read a frame into. The
// caller keeps it alive and does not touch it until next() hands it back
// or the prefetcher is closed.
void tpuflow_io_prefetcher_give(void* handle, float* buffer) {
  Prefetcher* p = static_cast<Prefetcher*>(handle);
  std::lock_guard<std::mutex> lock(p->mu);
  p->free_buffers.push_back(buffer);
  p->cv_free.notify_all();
}

// Blocks for the next frame in order: 0 with *buffer the filled buffer;
// kEnd after the last frame or a failure; a failure's code (errno,
// kWrongSize with *size the file's byte count) in its frame's place.
int tpuflow_io_prefetcher_next(void* handle, float** buffer, int64_t* size) {
  Prefetcher* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lock(p->mu);
  if (p->failed || p->handed >= p->paths.size()) return kEnd;
  // With nothing ready, no buffer given and none being read into, the
  // worker waits for a buffer, and this wait would not end.
  if (p->ready.empty() && p->free_buffers.empty() && !p->reading) return kNoBuffer;
  p->cv_ready.wait(lock, [&] { return !p->ready.empty(); });
  Prefetcher::Ready r = p->ready.front();
  p->ready.pop_front();
  p->handed++;
  *buffer = r.buffer;
  *size = r.size;
  if (r.code != 0) p->failed = true;
  return r.code;
}

// Stops the worker and waits for it; the buffers given are no longer used.
void tpuflow_io_prefetcher_close(void* handle) {
  Prefetcher* p = static_cast<Prefetcher*>(handle);
  {
    std::lock_guard<std::mutex> lock(p->mu);
    p->stop = true;
    p->cv_free.notify_all();
  }
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

// Read-ahead threads running now, for tests that check close() stops them.
int tpuflow_io_live_workers() { return live_workers.load(); }

}  // extern "C"
