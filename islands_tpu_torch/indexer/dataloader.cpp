// Native data loader: parallel file collection + line-aware chunking.
//
// The host feed of the indexing pipeline (config 1's corpus), so the device
// never waits on Python file IO. Semantics mirror
// islands_tpu_torch/indexer/files.py exactly (same skip rules, same chunk
// boundaries); parity is tested in tests/test_torch_files.py.
//
// A copy of the repository's native/dataloader.cpp with one change: chunk
// budgets count characters (UTF-8 code points), as files.chunk_text does,
// where native/dataloader.cpp counts bytes, so its chunk boundaries drift
// from the Python chunker's on any line with a non-ASCII character.
//
// C ABI (ctypes):
//   it_collect_chunks(root, exts_csv, chunk_size, chunk_overlap, n_threads,
//                     &out_buf, &out_len) -> 0 on success
//   it_free(buf)
//
// Output layout (little-endian, one contiguous buffer):
//   u64 num_chunks
//   repeated per chunk:
//     u32 path_len, bytes path (utf-8, repo-relative, '/'-separated)
//     u32 start_line, u32 end_line      (1-based inclusive)
//     u32 text_len,  bytes text (utf-8)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <filesystem>
#include <fstream>
#include <mutex>
#include <set>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace fs = std::filesystem;

namespace {

struct Chunk {
  std::string path;
  uint32_t start_line;
  uint32_t end_line;
  std::string text;
};

bool is_probably_utf8(const std::string& s) {
  // Cheap validation: reject files with NUL bytes or invalid UTF-8 lead
  // sequences (Python-side skips UnicodeDecodeError files).
  size_t i = 0;
  const auto* b = reinterpret_cast<const unsigned char*>(s.data());
  const size_t n = s.size();
  while (i < n) {
    unsigned char c = b[i];
    if (c == 0) return false;
    size_t need = c < 0x80 ? 0 : (c >> 5) == 0x6 ? 1 : (c >> 4) == 0xE ? 2
                  : (c >> 3) == 0x1E ? 3 : SIZE_MAX;
    if (need == SIZE_MAX || i + need >= n + 1) {
      if (need == SIZE_MAX) return false;
    }
    for (size_t k = 1; k <= need; ++k) {
      if (i + k >= n || (b[i + k] & 0xC0) != 0x80) return false;
    }
    i += need + 1;
  }
  return true;
}

std::vector<std::string> split_lines(const std::string& content) {
  // Python str.splitlines() subset: '\n' and '\r\n' (the overwhelmingly
  // common cases in source trees).
  std::vector<std::string> lines;
  size_t start = 0;
  for (size_t i = 0; i < content.size(); ++i) {
    if (content[i] == '\n') {
      size_t end = i;
      if (end > start && content[end - 1] == '\r') --end;
      lines.emplace_back(content.substr(start, end - start));
      start = i + 1;
    }
  }
  if (start < content.size()) {
    std::string last = content.substr(start);
    if (!last.empty() && last.back() == '\r') last.pop_back();
    lines.emplace_back(std::move(last));
  }
  return lines;
}

bool all_space(const std::string& s) {
  return std::all_of(s.begin(), s.end(),
                     [](unsigned char c) { return std::isspace(c); });
}

// Characters in a UTF-8 string: the bytes that do not continue a sequence.
size_t char_count(const std::string& s) {
  return static_cast<size_t>(std::count_if(
      s.begin(), s.end(), [](unsigned char c) { return (c & 0xC0) != 0x80; }));
}

// Mirror of files.chunk_text: line-aware windows of ~chunk_size characters
// with ~chunk_overlap characters of trailing context.
void chunk_text(const std::string& path, const std::string& content,
                size_t chunk_size, size_t chunk_overlap,
                std::vector<Chunk>& out) {
  if (all_space(content)) return;
  auto lines = split_lines(content);
  size_t n = lines.size();
  std::vector<size_t> len(n);
  for (size_t i = 0; i < n; ++i) len[i] = char_count(lines[i]);
  size_t start = 0;
  while (start < n) {
    size_t size = 0, end = start;
    while (end < n && (size == 0 || size + len[end] + 1 <= chunk_size)) {
      size += len[end] + 1;
      ++end;
    }
    std::string text;
    for (size_t i = start; i < end; ++i) {
      if (i > start) text += '\n';
      text += lines[i];
    }
    if (!all_space(text)) {
      out.push_back(Chunk{path, static_cast<uint32_t>(start + 1),
                          static_cast<uint32_t>(end), std::move(text)});
    }
    if (end >= n) break;
    size_t back = end, over = 0;
    while (back > start + 1 && over + len[back - 1] + 1 <= chunk_overlap) {
      over += len[back - 1] + 1;
      --back;
    }
    start = std::max(back, start + 1);
  }
}

bool skip_name(const std::string& name) {
  return (!name.empty() && name[0] == '.') || name == "node_modules" ||
         name == "target";
}

void walk(const fs::path& dir, const fs::path& root,
          const std::set<std::string>& exts, std::vector<fs::path>& files) {
  std::error_code ec;
  std::vector<fs::directory_entry> entries;
  for (auto it = fs::directory_iterator(dir, ec);
       !ec && it != fs::directory_iterator(); it.increment(ec)) {
    entries.push_back(*it);
  }
  std::sort(entries.begin(), entries.end(),
            [](const auto& a, const auto& b) { return a.path() < b.path(); });
  for (const auto& e : entries) {
    const std::string name = e.path().filename().string();
    if (skip_name(name)) continue;
    std::error_code ec2;
    if (e.is_directory(ec2) && !e.is_symlink(ec2)) {
      walk(e.path(), root, exts, files);
    } else if (e.is_regular_file(ec2)) {
      std::string ext = e.path().extension().string();
      if (!ext.empty() && ext[0] == '.') ext = ext.substr(1);
      if (exts.count(ext)) files.push_back(e.path());
    }
  }
}

}  // namespace

extern "C" {

int it_collect_chunks(const char* root_c, const char* exts_csv,
                      uint32_t chunk_size, uint32_t chunk_overlap,
                      uint32_t n_threads, char** out_buf, uint64_t* out_len) {
  try {
    fs::path root(root_c);
    if (!fs::exists(root)) return 2;
    std::set<std::string> exts;
    {
      std::stringstream ss(exts_csv);
      std::string item;
      while (std::getline(ss, item, ',')) {
        if (!item.empty()) exts.insert(item);
      }
    }
    std::vector<fs::path> files;
    walk(root, root, exts, files);

    // Parallel read + chunk; per-file results kept in input order so the
    // output is deterministic (matches the Python walker's sorted order).
    size_t nf = files.size();
    std::vector<std::vector<Chunk>> per_file(nf);
    unsigned hw = n_threads ? n_threads : std::thread::hardware_concurrency();
    hw = std::max(1u, std::min(hw, 16u));
    std::atomic<size_t> next{0};
    auto worker = [&]() {
      for (;;) {
        size_t i = next.fetch_add(1);
        if (i >= nf) return;
        std::ifstream f(files[i], std::ios::binary);
        if (!f) continue;
        std::string content((std::istreambuf_iterator<char>(f)),
                            std::istreambuf_iterator<char>());
        if (!is_probably_utf8(content)) continue;
        std::string rel = fs::relative(files[i], root).generic_string();
        chunk_text(rel, content, chunk_size, chunk_overlap, per_file[i]);
      }
    };
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < hw; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();

    // Serialize.
    uint64_t num_chunks = 0;
    size_t total = 8;
    for (const auto& v : per_file) {
      num_chunks += v.size();
      for (const auto& c : v) total += 4 + c.path.size() + 4 + 4 + 4 + c.text.size();
    }
    char* buf = static_cast<char*>(std::malloc(total));
    if (!buf) return 3;
    char* p = buf;
    auto put_u32 = [&p](uint32_t v) { std::memcpy(p, &v, 4); p += 4; };
    auto put_u64 = [&p](uint64_t v) { std::memcpy(p, &v, 8); p += 8; };
    put_u64(num_chunks);
    for (const auto& v : per_file) {
      for (const auto& c : v) {
        put_u32(static_cast<uint32_t>(c.path.size()));
        std::memcpy(p, c.path.data(), c.path.size());
        p += c.path.size();
        put_u32(c.start_line);
        put_u32(c.end_line);
        put_u32(static_cast<uint32_t>(c.text.size()));
        std::memcpy(p, c.text.data(), c.text.size());
        p += c.text.size();
      }
    }
    *out_buf = buf;
    *out_len = total;
    return 0;
  } catch (...) {
    return 1;
  }
}

void it_free(char* buf) { std::free(buf); }

}  // extern "C"
