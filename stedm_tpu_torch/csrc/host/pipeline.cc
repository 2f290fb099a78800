// Async WSI patch pipeline: a C++ worker pool that extracts patches from
// registered in-memory pyramid levels (crop with white fill outside the slide +
// block-mean downscale), the hot loop of
// `stedm_tpu_torch/data/wsi.py:wsi_sample` (reference her2_utils.py:177-208).
// The numpy path holds the GIL for most of its work; this pool runs whole
// batches off-thread so host decode overlaps both Python and device compute.
// Invoked via ctypes from stedm_tpu_torch/data/native_pipeline.py.
//
// A copy of native/pipeline.cc (the port builds its own host library).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Image {
  const uint8_t* data;  // non-owning; caller keeps the array alive
  int64_t h, w, c;
};

// one patch request: crop size*down starting at (y0, x0) in the image, fill
// out-of-bounds with 255, block-mean by `down`, write [size, size, c] uint8
struct Job {
  int64_t img_id, y0, x0, size, down;
  uint8_t* out;
};

void extract(const Image& im, const Job& j) {
  const int64_t c = im.c;
  const int64_t down = j.down > 0 ? j.down : 1;

  if (down == 1) {
    // pure crop: white-fill the row, memcpy the in-bounds span
    for (int64_t oy = 0; oy < j.size; ++oy) {
      uint8_t* out_row = j.out + (oy * j.size) * c;
      std::memset(out_row, 255, static_cast<size_t>(j.size) * c);
      const int64_t sy = j.y0 + oy;
      if (sy < 0 || sy >= im.h) continue;
      const int64_t sx_lo = j.x0 > 0 ? j.x0 : 0;
      const int64_t sx_hi = (j.x0 + j.size) < im.w ? (j.x0 + j.size) : im.w;
      if (sx_hi <= sx_lo) continue;
      std::memcpy(out_row + (sx_lo - j.x0) * c,
                  im.data + (sy * im.w + sx_lo) * c,
                  static_cast<size_t>(sx_hi - sx_lo) * c);
    }
    return;
  }

  const int64_t d2 = down * down;
  std::vector<uint32_t> acc(static_cast<size_t>(j.size) * c);
  for (int64_t oy = 0; oy < j.size; ++oy) {
    // start every accumulator from the all-white total, then swap white for
    // real pixels over the clipped spans — no per-pixel bounds checks
    const uint32_t white_total = static_cast<uint32_t>(255 * d2);
    for (size_t i = 0; i < acc.size(); ++i) acc[i] = white_total;
    const int64_t sy0 = j.y0 + oy * down;
    const int64_t sy_lo = sy0 > 0 ? sy0 : 0;
    const int64_t sy_hi = (sy0 + down) < im.h ? (sy0 + down) : im.h;
    for (int64_t sy = sy_lo; sy < sy_hi; ++sy) {
      const uint8_t* row = im.data + (sy * im.w) * c;
      for (int64_t ox = 0; ox < j.size; ++ox) {
        const int64_t sx0 = j.x0 + ox * down;
        const int64_t lo = sx0 > 0 ? sx0 : 0;
        const int64_t hi = (sx0 + down) < im.w ? (sx0 + down) : im.w;
        if (hi <= lo) continue;
        uint32_t* a = acc.data() + ox * c;
        for (int64_t sx = lo; sx < hi; ++sx) {
          const uint8_t* px = row + sx * c;
          for (int64_t k = 0; k < c; ++k) a[k] += px[k] - 255u;
        }
      }
    }
    uint8_t* out_row = j.out + (oy * j.size) * c;
    for (int64_t i = 0; i < j.size * c; ++i)
      out_row[i] = static_cast<uint8_t>(acc[i] / d2);
  }
}

struct Batch {
  std::vector<Job> jobs;
  std::atomic<int64_t> remaining{0};
};

struct Pipeline {
  std::vector<Image> images;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  // (batch, job index) work items; batches are owned by the ticket table
  std::deque<std::pair<Batch*, size_t>> queue;
  std::vector<Batch*> tickets;
  bool stop = false;

  explicit Pipeline(int n_workers) {
    for (int i = 0; i < n_workers; ++i)
      workers.emplace_back([this] { run(); });
  }

  void run() {
    for (;;) {
      std::pair<Batch*, size_t> item;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [this] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        item = queue.front();
        queue.pop_front();
      }
      Batch* b = item.first;
      const Job& j = b->jobs[item.second];
      extract(images[static_cast<size_t>(j.img_id)], j);
      if (b->remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(mu);
        cv_done.notify_all();
      }
    }
  }

  ~Pipeline() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
    for (Batch* b : tickets) delete b;
  }
};

}  // namespace

extern "C" {

// synchronous single-patch entry (the wsi_sample fast path): crop size*down at
// (y0, x0) with white fill, block-mean by down. ctypes releases the GIL for the
// call, so loader threads scale past numpy's GIL-held small-op sections.
void stedm_wsi_patch(const uint8_t* data, int64_t h, int64_t w, int64_t c,
                     int64_t y0, int64_t x0, int64_t size, int64_t down,
                     uint8_t* out) {
  Image im{data, h, w, c};
  extract(im, Job{0, y0, x0, size, down, out});
}

void* stedm_pipe_create(int64_t n_workers) {
  return new Pipeline(static_cast<int>(n_workers > 0 ? n_workers : 1));
}

int64_t stedm_pipe_register(void* handle, const uint8_t* data, int64_t h,
                            int64_t w, int64_t c) {
  auto* p = static_cast<Pipeline*>(handle);
  std::lock_guard<std::mutex> lk(p->mu);
  p->images.push_back(Image{data, h, w, c});
  return static_cast<int64_t>(p->images.size()) - 1;
}

// jobs: [n, 5] int64 rows (img_id, y0, x0, size, down); out: n contiguous
// [size, size, c] patches. Returns a ticket for stedm_pipe_wait.
int64_t stedm_pipe_submit(void* handle, const int64_t* jobs, int64_t n,
                          uint8_t* out) {
  auto* p = static_cast<Pipeline*>(handle);
  auto* b = new Batch();
  b->jobs.reserve(static_cast<size_t>(n));
  int64_t offset = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t* r = jobs + i * 5;
    const int64_t c = p->images[static_cast<size_t>(r[0])].c;
    b->jobs.push_back(Job{r[0], r[1], r[2], r[3], r[4], out + offset});
    offset += r[3] * r[3] * c;
  }
  b->remaining.store(n);
  int64_t ticket;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->tickets.push_back(b);
    ticket = static_cast<int64_t>(p->tickets.size()) - 1;
    for (size_t i = 0; i < b->jobs.size(); ++i) p->queue.emplace_back(b, i);
  }
  p->cv_work.notify_all();
  return ticket;
}

void stedm_pipe_wait(void* handle, int64_t ticket) {
  auto* p = static_cast<Pipeline*>(handle);
  Batch* b;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    b = p->tickets[static_cast<size_t>(ticket)];
  }
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_done.wait(lk, [b] { return b->remaining.load() == 0; });
}

void stedm_pipe_destroy(void* handle) { delete static_cast<Pipeline*>(handle); }

}  // extern "C"
