// Partitioned append-only event log: the framework's durable event backbone.
//
// TPU-native equivalent of the reference's Apache Pulsar deployment as used by
// Armada (internal/common/pulsarutils, internal/scheduler/publisher.go:25-60):
// an ordered, partitioned, replayable log that is the source of truth, with
// materialized views (scheduler DB, lookout DB, event streams) hanging off it.
// The reference outsources this to a Pulsar cluster; here it is an embedded
// native store so a single process group owns its log (no external broker).
//
// Design:
//   * N partitions, each an append-only file `p<k>.log` in the log directory.
//   * A record is [u32 paylen][u32 keylen][key][payload][u32 crc32(key+payload)].
//   * A message offset is the byte position of its record start; offsets are
//     monotonic per partition (comparable to Pulsar's (ledger, entry) message
//     ids, which the reference totally orders per partition).
//   * Readers scan forward from any offset; `el_read` copies whole records into
//     a caller buffer and returns the next offset (consumer position = the
//     high-water mark each materialized view persists, SURVEY.md section 5
//     "checkpoint/resume").
//   * On open, each partition tail is scanned and torn trailing writes are
//     truncated (crash recovery).
//   * Writes take a per-partition mutex; `el_flush` fsyncs everything (the
//     publisher calls it at batch boundaries, like Pulsar producer flush).
//
// Built as a shared library; Python binds via ctypes (armada_tpu/eventlog/log.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

uint32_t crc32_table[256];
std::once_flag crc32_once;

void crc32_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc32_table[i] = c;
  }
}

uint32_t crc32(const uint8_t* a, size_t an, const uint8_t* b, size_t bn) {
  std::call_once(crc32_once, crc32_init);
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < an; i++) c = crc32_table[(c ^ a[i]) & 0xFF] ^ (c >> 8);
  for (size_t i = 0; i < bn; i++) c = crc32_table[(c ^ b[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Partition {
  int fd = -1;
  int64_t end = 0;  // next append offset (== file size after recovery)
  std::mutex mu;
};

struct Log {
  std::string dir;
  std::vector<Partition> parts;
};

constexpr size_t kHeader = 8;   // paylen + keylen
constexpr size_t kTrailer = 4;  // crc
// Size caps shared by append and read: a record violating them is corrupt.
constexpr uint32_t kMaxPayload = 1u << 30;
constexpr uint32_t kMaxKey = 1u << 20;

// Validate the record at `off` in fd of size `size`. Returns record total
// length, or a negative classification:
//   -1  TORN -- the record is incomplete at the end of the region (header
//       does not fit, the declared length runs past `size`, or a CRC-failed
//       record that ends EXACTLY at `size`).  A crash mid-append tears the
//       FINAL record only: pwrite lays down a contiguous prefix and the
//       unfsynced tail sectors may not all have landed, but everything it
//       tears sits at the end of the file.
//   -2  CORRUPT -- an invalid record with more data after it (a mid-log CRC
//       mismatch, or insane declared lengths whose claimed extent fits
//       inside the region).  This is disk damage, never crash residue.
// With verify_crc, the body is read and checksummed too (used by the
// open-time recovery scan and by el_read).
int64_t record_len_at(int fd, int64_t off, int64_t size, bool verify_crc) {
  if (off + (int64_t)(kHeader + kTrailer) > size) return -1;
  uint8_t hdr[kHeader];
  if (pread(fd, hdr, kHeader, off) != (ssize_t)kHeader) return -1;
  uint32_t paylen, keylen;
  memcpy(&paylen, hdr, 4);
  memcpy(&keylen, hdr + 4, 4);
  int64_t total = kHeader + keylen + paylen + kTrailer;
  if (paylen > kMaxPayload || keylen > kMaxKey) {
    // Insane lengths whose claimed extent still runs past the region end
    // look exactly like a torn partial header at the tail (arbitrary
    // bytes where a header never finished landing); a claimed extent
    // that FITS inside the region is damage.
    return off + total > size ? -1 : -2;
  }
  if (off + total > size) return -1;
  if (verify_crc) {
    std::vector<uint8_t> body(keylen + paylen + kTrailer);
    if (pread(fd, body.data(), body.size(), off + kHeader) !=
        (ssize_t)body.size())
      return -1;
    uint32_t stored;
    memcpy(&stored, body.data() + keylen + paylen, 4);
    if (crc32(body.data(), keylen, body.data() + keylen, paylen) != stored)
      return off + total == size ? -1 : -2;
  }
  return total;
}

}  // namespace

extern "C" {

void* el_open(const char* dir, int num_partitions) {
  Log* log = new Log();
  log->dir = dir;
  mkdir(dir, 0755);
  log->parts = std::vector<Partition>(num_partitions);
  for (int k = 0; k < num_partitions; k++) {
    std::string path = log->dir + "/p" + std::to_string(k) + ".log";
    int fd = open(path.c_str(), O_RDWR | O_CREAT, 0644);
    if (fd < 0) {
      for (int j = 0; j < k; j++) close(log->parts[j].fd);
      delete log;
      return nullptr;
    }
    struct stat st;
    fstat(fd, &st);
    // Crash recovery: walk records from 0, verifying checksums.  A TORN
    // final record (crash mid-append) is truncated away -- the publisher
    // never acked it, so dropping it loses nothing.  A CORRUPT record
    // with data after it is disk damage: acked records would silently
    // vanish if we truncated here, so the open FAILS loudly instead
    // (operator restores from a replica or checkpoint; docs/operations.md).
    int64_t off = 0;
    int64_t total = 0;
    while (off < st.st_size) {
      total = record_len_at(fd, off, st.st_size, /*verify_crc=*/true);
      if (total < 0) break;
      off += total;
    }
    if (total == -2) {
      fprintf(stderr,
              "eventlog: corrupt record (not a torn tail) in %s at offset "
              "%lld; refusing to open\n",
              path.c_str(), (long long)off);
      close(fd);
      for (int j = 0; j < k; j++) close(log->parts[j].fd);
      delete log;
      return nullptr;
    }
    if (off < st.st_size) {
      if (ftruncate(fd, off) != 0) { /* keep going; end still caps reads */
      }
    }
    log->parts[k].fd = fd;
    log->parts[k].end = off;
  }
  return log;
}

void el_close(void* h) {
  Log* log = (Log*)h;
  if (!log) return;
  for (auto& p : log->parts)
    if (p.fd >= 0) close(p.fd);
  delete log;
}

int el_num_partitions(void* h) { return (int)((Log*)h)->parts.size(); }

// Append one record; returns its offset, or -1 on error.
int64_t el_append(void* h, int part, const void* key, int keylen,
                  const void* payload, int paylen) {
  Log* log = (Log*)h;
  if (part < 0 || part >= (int)log->parts.size()) return -1;
  if (keylen < 0 || (uint32_t)keylen > kMaxKey || paylen < 0 ||
      (uint32_t)paylen > kMaxPayload)
    return -1;  // would be unreadable: reject at write time, not read time
  Partition& p = log->parts[part];
  std::lock_guard<std::mutex> lock(p.mu);
  uint32_t pl = (uint32_t)paylen, kl = (uint32_t)keylen;
  uint32_t crc = crc32((const uint8_t*)key, kl, (const uint8_t*)payload, pl);
  size_t total = kHeader + kl + pl + kTrailer;
  std::vector<uint8_t> buf(total);
  memcpy(buf.data(), &pl, 4);
  memcpy(buf.data() + 4, &kl, 4);
  memcpy(buf.data() + kHeader, key, kl);
  memcpy(buf.data() + kHeader + kl, payload, pl);
  memcpy(buf.data() + kHeader + kl + pl, &crc, 4);
  int64_t off = p.end;
  ssize_t n = pwrite(p.fd, buf.data(), total, off);
  if (n != (ssize_t)total) {
    // Undo a partial write so the tail stays clean.
    if (ftruncate(p.fd, off) != 0) { /* recovery scan will fix on reopen */
    }
    return -1;
  }
  p.end = off + total;
  return off;
}

int64_t el_end_offset(void* h, int part) {
  Log* log = (Log*)h;
  if (part < 0 || part >= (int)log->parts.size()) return -1;
  return log->parts[part].end;
}

// Copy whole records starting at `offset` into buf (framing preserved) until
// buf is full, max_msgs records are copied, or the partition end is reached.
// Returns bytes written; *next_offset is where the next read should start.
int64_t el_read(void* h, int part, int64_t offset, void* buf, int64_t max_bytes,
                int64_t max_msgs, int64_t* next_offset) {
  Log* log = (Log*)h;
  if (part < 0 || part >= (int)log->parts.size()) return -1;
  Partition& p = log->parts[part];
  int64_t end;
  {
    std::lock_guard<std::mutex> lock(p.mu);
    end = p.end;
  }
  int64_t written = 0, off = offset, msgs = 0;
  uint8_t* out = (uint8_t*)buf;
  while (off < end && msgs < max_msgs) {
    int64_t total = record_len_at(p.fd, off, end, /*verify_crc=*/false);
    if (total < 0) return -2;  // corruption below `end`: surface loudly
    if (written + total > max_bytes) {
      // Caller's buffer can't hold even one record: distinguish from
      // caught-up so the reader can retry with a bigger buffer instead of
      // silently treating the partition as drained.
      if (msgs == 0) return -3;
      break;
    }
    if (pread(p.fd, out + written, total, off) != (ssize_t)total) break;
    // Verify the checksum on the copied bytes (no second disk read).
    uint8_t* rec = out + written;
    uint32_t paylen, keylen, stored;
    memcpy(&paylen, rec, 4);
    memcpy(&keylen, rec + 4, 4);
    memcpy(&stored, rec + kHeader + keylen + paylen, 4);
    if (crc32(rec + kHeader, keylen, rec + kHeader + keylen, paylen) != stored)
      return -2;
    written += total;
    off += total;
    msgs++;
  }
  *next_offset = off;
  return written;
}

int el_flush(void* h) {
  Log* log = (Log*)h;
  int rc = 0;
  for (auto& p : log->parts) {
    std::lock_guard<std::mutex> lock(p.mu);
    if (p.fd >= 0 && fsync(p.fd) != 0) rc = -1;
  }
  return rc;
}

// Truncate one partition to `offset` (divergence recovery: a follower
// drops an unacked suffix back to the last common prefix with the leader).
// `offset` must be <= the current end; the caller is responsible for it
// being a record boundary (the open-time recovery scan would truncate a
// mid-record cut anyway, but the in-memory end would briefly disagree).
int el_truncate(void* h, int part, int64_t offset) {
  Log* log = (Log*)h;
  if (part < 0 || part >= (int)log->parts.size()) return -1;
  Partition& p = log->parts[part];
  std::lock_guard<std::mutex> lock(p.mu);
  if (offset < 0 || offset > p.end) return -1;
  if (ftruncate(p.fd, offset) != 0) return -1;
  if (fsync(p.fd) != 0) return -1;
  p.end = offset;
  return 0;
}

// Truncate every partition to zero (test helper / dev reset).
int el_reset(void* h) {
  Log* log = (Log*)h;
  for (auto& p : log->parts) {
    std::lock_guard<std::mutex> lock(p.mu);
    if (ftruncate(p.fd, 0) != 0) return -1;
    p.end = 0;
  }
  return 0;
}

}  // extern "C"
