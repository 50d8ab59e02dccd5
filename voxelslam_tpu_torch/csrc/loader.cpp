// Native prefetching dataset loader of the PyTorch port
// (voxelslam_tpu_torch): the port's copy of the JAX package's
// native/loader.cpp, built with g++ together with ingest.cpp by
// voxelslam_tpu_torch/native.py and bound with ctypes.
//
// The reference receives scans through ROS subscriber callbacks on
// dedicated spinner threads and pairs them with IMU under a mutex
// (`sync_packages`, voxelslam.hpp:52-177 in the reference tree). Here the
// recorded-dataset runner gets the same overlap: a C++ producer thread
// walks scans.txt, reads each .npy scan file, decodes/filters/sorts the
// points (same rules as ingest.cpp vs_decode), and stages ready packets
// in a bounded ring buffer while the device processes the previous scan.
// The Python side only copies out completed buffers.
//
// Supported .npy payloads (matching cli._load_scan_file):
//   * plain (N, 3) or (N, 4) float32/float64 arrays: x y z [t_offset]
//   * structured record arrays with x/y/z[,time-ish,intensity] fields —
//     field offsets resolved from the npy header's descr list.
//
// Plain C ABI for ctypes. One loader handle = one producer thread.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <numeric>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// npy parsing
// ---------------------------------------------------------------------------

struct NpyField {
  std::string name;
  int64_t offset = -1;
  int type = -1;   // type codes as in ingest.cpp read_field
  int size = 0;
};

struct NpyHeader {
  bool ok = false;
  bool fortran = false;
  int64_t rows = 0, cols = 1;
  int64_t itemsize = 0;
  int scalar_type = -1;            // set for plain arrays
  std::vector<NpyField> fields;    // set for structured arrays
  int64_t data_offset = 0;
};

int dtype_code(const std::string& d, int* size) {
  // d like "<f4", "|u1", ">f8" (big-endian unsupported -> -1)
  if (d.size() < 3) return -1;
  char order = d[0];
  char kind = d[1];
  int sz = std::atoi(d.c_str() + 2);
  *size = sz;
  if (order == '>') return -1;
  if (kind == 'f' && sz == 4) return 0;
  if (kind == 'f' && sz == 8) return 1;
  if (kind == 'u' && sz == 4) return 2;
  if (kind == 'i' && sz == 4) return 3;
  if (kind == 'u' && sz == 2) return 4;
  if (kind == 'u' && sz == 1) return 5;
  if (kind == 'i' && sz == 8) return 6;
  if (kind == 'u' && sz == 8) return 7;
  return -1;
}

// Extract the next python string literal starting at or after `pos`.
bool next_str(const std::string& s, size_t* pos, std::string* out) {
  size_t q = s.find_first_of("'\"", *pos);
  if (q == std::string::npos) return false;
  char quote = s[q];
  size_t e = s.find(quote, q + 1);
  if (e == std::string::npos) return false;
  *out = s.substr(q + 1, e - q - 1);
  *pos = e + 1;
  return true;
}

NpyHeader parse_npy_header(FILE* f) {
  NpyHeader h;
  uint8_t magic[8];
  if (std::fread(magic, 1, 8, f) != 8) return h;
  if (std::memcmp(magic, "\x93NUMPY", 6) != 0) return h;
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    uint16_t l16;
    if (std::fread(&l16, 2, 1, f) != 1) return h;
    hlen = l16;
    h.data_offset = 10 + hlen;
  } else {
    if (std::fread(&hlen, 4, 1, f) != 1) return h;
    h.data_offset = 12 + hlen;
  }
  std::string hdr(hlen, '\0');
  if (std::fread(&hdr[0], 1, hlen, f) != hlen) return h;

  // fortran_order
  size_t fo = hdr.find("'fortran_order'");
  if (fo != std::string::npos)
    h.fortran = hdr.find("True", fo) < hdr.find("}", fo);

  // shape tuple
  size_t sh = hdr.find("'shape'");
  if (sh == std::string::npos) return h;
  size_t lp = hdr.find('(', sh);
  size_t rp = hdr.find(')', lp);
  if (lp == std::string::npos || rp == std::string::npos) return h;
  std::string shape = hdr.substr(lp + 1, rp - lp - 1);
  {
    std::vector<int64_t> dims;
    const char* p = shape.c_str();
    while (*p) {
      while (*p && !std::isdigit(*p)) ++p;
      if (!*p) break;
      dims.push_back(std::strtoll(p, const_cast<char**>(&p), 10));
    }
    if (dims.empty()) return h;
    h.rows = dims[0];
    h.cols = dims.size() > 1 ? dims[1] : 1;
    if (dims.size() > 2) return h;
  }

  // descr: either a plain "'<f4'" or a list of ('name', '<f4') tuples
  size_t de = hdr.find("'descr'");
  if (de == std::string::npos) return h;
  size_t colon = hdr.find(':', de);
  size_t firstc = hdr.find_first_not_of(" \t", colon + 1);
  if (firstc == std::string::npos) return h;
  if (hdr[firstc] == '[') {
    // structured: walk ('name', '<t#'[, shape]) tuples
    size_t end = firstc;
    int depth = 0;
    for (; end < hdr.size(); ++end) {
      if (hdr[end] == '[') depth++;
      else if (hdr[end] == ']' && --depth == 0) break;
    }
    std::string body = hdr.substr(firstc, end - firstc + 1);
    size_t pos = 1;
    int64_t off = 0;
    while (true) {
      size_t tp = body.find('(', pos);
      if (tp == std::string::npos) break;
      pos = tp + 1;
      std::string name, dt;
      if (!next_str(body, &pos, &name)) break;
      if (!next_str(body, &pos, &dt)) break;
      // optional per-field shape (we only support scalar fields;
      // shaped fields just advance the offset)
      int64_t mult = 1;
      size_t close = body.find(')', pos);
      std::string between = body.substr(pos, close - pos);
      if (between.find('(') != std::string::npos) {
        const char* p = between.c_str();
        mult = 0;
        int64_t cur = 1;
        bool any = false;
        while (*p) {
          while (*p && !std::isdigit(*p)) ++p;
          if (!*p) break;
          cur *= std::strtoll(p, const_cast<char**>(&p), 10);
          any = true;
        }
        mult = any ? cur : 1;
      }
      NpyField fld;
      int sz = 0;
      fld.type = dtype_code(dt, &sz);
      fld.name = name;
      fld.offset = off;
      fld.size = sz;
      off += (int64_t)sz * mult;
      if (mult == 1) h.fields.push_back(fld);
      pos = close + 1;
    }
    h.itemsize = off;
    h.cols = 1;
    if (h.fields.empty() || off <= 0) return h;
  } else {
    std::string dt;
    size_t pos = firstc;
    if (!next_str(hdr, &pos, &dt)) return h;
    int sz = 0;
    h.scalar_type = dtype_code(dt, &sz);
    if (h.scalar_type < 0) return h;
    h.itemsize = sz;
  }
  h.ok = true;
  return h;
}

inline double read_field_raw(const uint8_t* rec, int64_t off, int type) {
  switch (type) {
    case 0: { float v;    std::memcpy(&v, rec + off, 4); return v; }
    case 1: { double v;   std::memcpy(&v, rec + off, 8); return v; }
    case 2: { uint32_t v; std::memcpy(&v, rec + off, 4); return v; }
    case 3: { int32_t v;  std::memcpy(&v, rec + off, 4); return v; }
    case 4: { uint16_t v; std::memcpy(&v, rec + off, 2); return v; }
    case 5: { uint8_t v;  std::memcpy(&v, rec + off, 1); return v; }
    case 6: { int64_t v;  std::memcpy(&v, rec + off, 8); return (double)v; }
    case 7: { uint64_t v; std::memcpy(&v, rec + off, 8); return (double)v; }
    default: return 0.0;
  }
}

// ---------------------------------------------------------------------------
// loader
// ---------------------------------------------------------------------------

struct Packet {
  double t_beg = 0, t_end = 0;
  std::vector<float> xyz;   // (m, 3)
  std::vector<float> off;   // (m,)
  bool ok = false;          // decode success
  std::string error;
};

struct ScanRow {
  double t_beg, t_end;
  std::string path;
};

struct Loader {
  std::vector<ScanRow> rows;
  // decode params (mirroring ingest.cpp vs_decode)
  double blind = 0.5;
  int64_t filter_num = 1;
  double max_offset = 0.11;
  double t_scale = 1.0;
  int t_absolute = 0;
  std::vector<std::string> time_fields;

  size_t prefetch = 4;
  std::deque<Packet> queue;
  size_t next_produce = 0;   // rows claimed by the producer
  size_t consumed = 0;       // packets handed to the consumer
  std::mutex mu;
  std::condition_variable cv_prod, cv_cons;
  std::atomic<bool> stop{false};
  std::thread worker;

  ~Loader() {
    stop.store(true);
    cv_prod.notify_all();
    cv_cons.notify_all();
    if (worker.joinable()) worker.join();
  }
};

Packet decode_file(const Loader& L, const ScanRow& row) {
  Packet pkt;
  pkt.t_beg = row.t_beg;
  pkt.t_end = row.t_end;
  FILE* f = std::fopen(row.path.c_str(), "rb");
  if (!f) { pkt.error = "open failed: " + row.path; return pkt; }
  NpyHeader h = parse_npy_header(f);
  if (!h.ok || h.fortran) {
    std::fclose(f);
    pkt.error = "unsupported npy: " + row.path;
    return pkt;
  }
  const int64_t stride = h.itemsize * (h.fields.empty() ? h.cols : 1);
  std::vector<uint8_t> raw((size_t)(h.rows * stride));
  std::fseek(f, (long)h.data_offset, SEEK_SET);
  size_t got = std::fread(raw.data(), 1, raw.size(), f);
  std::fclose(f);
  if (got != raw.size()) { pkt.error = "short read: " + row.path; return pkt; }

  int64_t off_x, off_y, off_z, off_t = -1;
  int tx, ty, tz, tt = 0;
  double t_scale = L.t_scale;
  int t_absolute = L.t_absolute;
  if (!h.fields.empty()) {
    auto find = [&](const char* n, int64_t* o, int* t) {
      for (const auto& fl : h.fields)
        if (fl.name == n) { *o = fl.offset; *t = fl.type; return true; }
      return false;
    };
    off_x = off_y = off_z = -1;
    tx = ty = tz = 0;
    find("x", &off_x, &tx);
    find("y", &off_y, &ty);
    find("z", &off_z, &tz);
    if (off_x < 0 || off_y < 0 || off_z < 0) {
      pkt.error = "no x/y/z fields: " + row.path;
      return pkt;
    }
    for (const auto& name : L.time_fields)
      if (find(name.c_str(), &off_t, &tt)) break;
  } else {
    if (h.cols != 3 && h.cols != 4) {
      pkt.error = "expected (N,3)/(N,4): " + row.path;
      return pkt;
    }
    tx = ty = tz = tt = h.scalar_type;
    off_x = 0;
    off_y = h.itemsize;
    off_z = 2 * h.itemsize;
    off_t = (h.cols == 4) ? 3 * h.itemsize : -1;
    t_scale = 1.0;       // plain arrays carry offsets in seconds already
    t_absolute = 0;
  }

  const double blind2 = L.blind * L.blind;
  const int64_t n = h.rows;
  double t_min = 0.0;
  if (t_absolute && off_t >= 0) {
    t_min = 1e300;
    for (int64_t k = 0; k < n; ++k)
      t_min = std::min(t_min,
                       read_field_raw(raw.data() + k * stride, off_t, tt));
  }
  std::vector<float> xs, ys, zs, ts;
  xs.reserve(n); ys.reserve(n); zs.reserve(n); ts.reserve(n);
  int64_t kept_raw = 0;
  const int64_t fnum = L.filter_num < 1 ? 1 : L.filter_num;
  for (int64_t k = 0; k < n; ++k) {
    const uint8_t* rec = raw.data() + k * stride;
    const double x = read_field_raw(rec, off_x, tx);
    const double y = read_field_raw(rec, off_y, ty);
    const double z = read_field_raw(rec, off_z, tz);
    const double r2 = x * x + y * y + z * z;
    if (!(r2 > blind2) || !std::isfinite(x) || !std::isfinite(y) ||
        !std::isfinite(z))
      continue;
    if ((kept_raw++ % fnum) != 0) continue;
    double t = 0.0;
    if (off_t >= 0) {
      t = read_field_raw(rec, off_t, tt);
      if (t_absolute) t -= t_min;
      t *= t_scale;
    }
    if (t > L.max_offset) continue;
    xs.push_back((float)x); ys.push_back((float)y); zs.push_back((float)z);
    ts.push_back((float)t);
  }
  const int64_t m = (int64_t)xs.size();
  std::vector<int64_t> order(m);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return ts[a] < ts[b]; });
  pkt.xyz.resize(3 * m);
  pkt.off.resize(m);
  for (int64_t k = 0; k < m; ++k) {
    const int64_t s = order[k];
    pkt.xyz[3 * k + 0] = xs[s];
    pkt.xyz[3 * k + 1] = ys[s];
    pkt.xyz[3 * k + 2] = zs[s];
    pkt.off[k] = ts[s];
  }
  pkt.ok = true;
  return pkt;
}

void produce(Loader* L) {
  while (!L->stop.load()) {
    size_t idx;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_prod.wait(lk, [&] {
        return L->stop.load() || (L->queue.size() < L->prefetch &&
                                  L->next_produce < L->rows.size());
      });
      if (L->stop.load() || L->next_produce >= L->rows.size()) return;
      idx = L->next_produce++;
    }
    Packet pkt = decode_file(*L, L->rows[idx]);
    {
      std::lock_guard<std::mutex> lk(L->mu);
      L->queue.push_back(std::move(pkt));
    }
    L->cv_cons.notify_one();
  }
}

}  // namespace

extern "C" {

// scans_index: newline-separated "t_beg t_end /abs/path" rows (the
// caller pre-resolves paths); time_fields: comma-separated candidate
// structured time field names in priority order.
void* vs_loader_open(const char* scans_index, const char* time_fields,
                     double t_scale, int t_absolute, double blind,
                     int64_t filter_num, double max_offset,
                     int64_t prefetch) {
  auto* L = new Loader();
  L->blind = blind;
  L->filter_num = filter_num;
  L->max_offset = max_offset;
  L->t_scale = t_scale;
  L->t_absolute = t_absolute;
  L->prefetch = (size_t)(prefetch < 1 ? 1 : prefetch);
  {
    std::string tf = time_fields ? time_fields : "";
    size_t pos = 0;
    while (pos < tf.size()) {
      size_t c = tf.find(',', pos);
      if (c == std::string::npos) c = tf.size();
      if (c > pos) L->time_fields.push_back(tf.substr(pos, c - pos));
      pos = c + 1;
    }
  }
  {
    std::string idx = scans_index ? scans_index : "";
    size_t pos = 0;
    while (pos < idx.size()) {
      size_t e = idx.find('\n', pos);
      if (e == std::string::npos) e = idx.size();
      std::string line = idx.substr(pos, e - pos);
      pos = e + 1;
      if (line.empty()) continue;
      ScanRow row;
      char pathbuf[4096];
      if (std::sscanf(line.c_str(), "%lf %lf %4095s",
                      &row.t_beg, &row.t_end, pathbuf) == 3) {
        row.path = pathbuf;
        L->rows.push_back(std::move(row));
      }
    }
  }
  L->worker = std::thread(produce, L);
  return L;
}

int64_t vs_loader_count(void* handle) {
  return (int64_t) static_cast<Loader*>(handle)->rows.size();
}

// Fetch the next packet. Blocks until the producer has it. Returns the
// point count m (copied into out_xyz (cap,3) / out_off (cap,), truncated
// at cap), -1 at end of dataset, -2 on a decode error (skipped file).
int64_t vs_loader_next(void* handle, float* out_xyz, float* out_off,
                       int64_t cap, double* out_t_beg, double* out_t_end) {
  auto* L = static_cast<Loader*>(handle);
  Packet pkt;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    // end-of-stream must count CONSUMED packets, not producer-claimed
    // rows: the producer bumps next_produce before its packet reaches
    // the queue, so checking next_produce here dropped in-flight tail
    // scans when the consumer outran the decode of the last file.
    if (L->consumed >= L->rows.size()) return -1;
    L->cv_cons.wait(lk, [&] { return L->stop.load() || !L->queue.empty(); });
    if (L->queue.empty()) return -1;
    pkt = std::move(L->queue.front());
    L->queue.pop_front();
    L->consumed++;
  }
  L->cv_prod.notify_one();
  *out_t_beg = pkt.t_beg;
  *out_t_end = pkt.t_end;
  if (!pkt.ok) return -2;
  const int64_t m = std::min<int64_t>((int64_t)pkt.off.size(), cap);
  std::memcpy(out_xyz, pkt.xyz.data(), (size_t)m * 3 * sizeof(float));
  std::memcpy(out_off, pkt.off.data(), (size_t)m * sizeof(float));
  return m;
}

void vs_loader_close(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
