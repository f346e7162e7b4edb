// Counts the kernels the card runs, by name, from CUPTI's activity records
// (CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL: one record per kernel that ran,
// a graph replay's kernels one by one).  Only the counts are kept, so a
// run of millions of kernels costs a few MB of host memory.  Host code
// with a plain C interface, bound by utils/kernel_events.py; it links no
// CUPTI itself and takes the symbols of the CUPTI the process has loaded.
//
// One session at a time: ke_start, the work, a synchronisation of the
// device, ke_stop, then ke_counts and ke_dropped.

#include <cupti.h>
#include <cxxabi.h>

#include <cstdint>
#include <cstdlib>
#include <mutex>
#include <string>
#include <unordered_map>

namespace {

constexpr size_t kBufferBytes = 8u << 20;

std::mutex mu;
std::unordered_map<std::string, long long> counts;  // mangled name -> runs
long long dropped = 0;
std::string text;

void CUPTIAPI buffer_requested(uint8_t** buffer, size_t* size,
                               size_t* max_records) {
  *buffer = static_cast<uint8_t*>(std::aligned_alloc(8, kBufferBytes));
  *size = *buffer ? kBufferBytes : 0;
  *max_records = 0;
}

void CUPTIAPI buffer_completed(CUcontext ctx, uint32_t stream_id,
                               uint8_t* buffer, size_t, size_t valid) {
  {
    std::lock_guard<std::mutex> lock(mu);
    CUpti_Activity* rec = nullptr;
    while (cuptiActivityGetNextRecord(buffer, valid, &rec) == CUPTI_SUCCESS) {
      if (rec->kind == CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL ||
          rec->kind == CUPTI_ACTIVITY_KIND_KERNEL) {
        // `name` sits where it has since version 4 of the record
        const char* name =
            reinterpret_cast<const CUpti_ActivityKernel4*>(rec)->name;
        ++counts[name ? name : "?"];
      }
    }
    size_t n = 0;
    if (cuptiActivityGetNumDroppedRecords(ctx, stream_id, &n) ==
        CUPTI_SUCCESS)
      dropped += (long long)n;
  }
  std::free(buffer);
}

}  // namespace

// Clears the counts and starts recording; returns a CUptiResult.
extern "C" int ke_start(unsigned flush_period_ms) {
  {
    std::lock_guard<std::mutex> lock(mu);
    counts.clear();
    dropped = 0;
  }
  CUptiResult r =
      cuptiActivityRegisterCallbacks(buffer_requested, buffer_completed);
  if (r != CUPTI_SUCCESS) return (int)r;
  // hand full buffers over as the run goes, not all at the end
  r = cuptiActivityFlushPeriod(flush_period_ms);
  if (r != CUPTI_SUCCESS) return (int)r;
  return (int)cuptiActivityEnable(CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL);
}

// Stops recording and takes in every record of the session; call it after
// the device has finished the session's work.  Returns a CUptiResult.
extern "C" int ke_stop() {
  const CUptiResult d =
      cuptiActivityDisable(CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL);
  const CUptiResult f = cuptiActivityFlushAll(CUPTI_ACTIVITY_FLAG_FLUSH_FORCED);
  cuptiActivityFlushPeriod(0);
  return (int)(d != CUPTI_SUCCESS ? d : f);
}

// Records CUPTI could not keep in the last session (0 when none).
extern "C" long long ke_dropped() {
  std::lock_guard<std::mutex> lock(mu);
  return dropped;
}

// The last session's counts, one "runs<TAB>demangled name" line per kernel.
extern "C" const char* ke_counts() {
  std::lock_guard<std::mutex> lock(mu);
  text.clear();
  for (const auto& kv : counts) {
    int status = 0;
    char* dem = abi::__cxa_demangle(kv.first.c_str(), nullptr, nullptr,
                                    &status);
    text += std::to_string(kv.second) + "\t" +
            (status == 0 && dem ? dem : kv.first) + "\n";
    std::free(dem);
  }
  return text.c_str();
}

extern "C" const char* ke_error(int code) {
  const char* s = nullptr;
  cuptiGetResultString((CUptiResult)code, &s);
  return s ? s : "unknown CUPTI error";
}
