// Byte-pair encoder — the host-side tokenization hot path.
//
// The serving engine tokenizes every request on the CPU before the
// device sees it; in Python the greedy merge loop dominates request
// admission at high QPS. This implements the classic rank-based BPE
// merge with a doubly-linked part list + lazy min-heap: O(n log n)
// over the text instead of the O(n^2) scan of the Python fallback
// (gofr_tpu_torch/serving/tokenizer.py:_bpe_merge), called through ctypes
// (which releases the GIL, so tokenization overlaps device steps).
//
// Two vocabulary styles share the loop:
//   * tiktoken: the output id IS the merge priority (ranks only);
//   * HF tokenizer.json: merge priority comes from the merges list,
//     output ids from the vocab — bpe_add_merge switches the pair
//     lookup to the merge table while final emission keeps ranks.
// Pre-tokenizer boundaries (HF splits text with a regex before BPE)
// ride the same native call as byte offsets merges may not cross, so
// a whole request still tokenizes in ONE GIL-released call.
//
// C ABI:
//   bpe_create() -> handle
//   bpe_add_token(handle, bytes, len, rank)   // build vocabulary
//   bpe_add_merge(handle, bytes, len, prio)   // optional HF merge table
//   bpe_finalize(handle)                      // index pairs
//   bpe_encode(handle, text, len, out, cap) -> n tokens (or -1 overflow)
//   bpe_encode_bounded(handle, text, len, bounds, nbounds, out, cap)
//       // bounds: sorted byte offsets starting a new piece
//   bpe_destroy(handle)

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Encoder {
    std::unordered_map<std::string, int32_t> ranks;   // piece -> id
    std::unordered_map<std::string, int32_t> merges;  // piece -> priority
    bool use_merges = false;
};

struct Part {
    uint32_t start;   // byte offset into the text
    uint32_t len;     // current token length in bytes
    int32_t prev;     // index of previous live part, -1 at head
    int32_t next;     // index of next live part, -1 at tail
    uint64_t version; // bumped on every merge touching this part
    bool alive;
};

struct HeapEntry {
    int32_t rank;
    int32_t left;           // part index
    uint64_t left_version;  // staleness: left part grew since push
    uint32_t right_start;   // staleness: right partner replaced
    uint64_t right_version; // staleness: right partner grew since push
    bool operator>(const HeapEntry& o) const {
        if (rank != o.rank) return rank > o.rank;
        return left > o.left; // deterministic leftmost-first tie-break
    }
};

int32_t pair_rank(const Encoder* e, const uint8_t* text, const Part& a,
                  const Part& b) {
    std::string key(reinterpret_cast<const char*>(text + a.start),
                    a.len + b.len);
    const auto& table = e->use_merges ? e->merges : e->ranks;
    auto it = table.find(key);
    return it == table.end() ? -1 : it->second;
}

}  // namespace

extern "C" {

void* bpe_create() { return new Encoder(); }

void bpe_add_token(void* h, const uint8_t* bytes, int len, int32_t rank) {
    auto* e = static_cast<Encoder*>(h);
    e->ranks.emplace(std::string(reinterpret_cast<const char*>(bytes), len),
                     rank);
}

void bpe_add_merge(void* h, const uint8_t* bytes, int len, int32_t prio) {
    auto* e = static_cast<Encoder*>(h);
    e->merges.emplace(std::string(reinterpret_cast<const char*>(bytes), len),
                      prio);
    e->use_merges = true;
}

void bpe_finalize(void*) {}  // reserved for a future pair index

int bpe_encode_bounded(void* h, const uint8_t* text, int len,
                       const int32_t* bounds, int nbounds, int32_t* out,
                       int out_cap) {
    auto* e = static_cast<Encoder*>(h);
    if (len <= 0) return 0;

    // piece boundaries: a merge may never bridge two pre-tokenizer
    // pieces — any pair whose right side STARTS a piece is forbidden
    std::vector<uint8_t> boundary(len, 0);
    for (int i = 0; i < nbounds; ++i) {
        int32_t b = bounds[i];
        if (b > 0 && b < len) boundary[b] = 1;
    }

    std::vector<Part> parts(len);
    for (int i = 0; i < len; ++i) {
        parts[i] = {static_cast<uint32_t>(i), 1, i - 1,
                    i + 1 < len ? i + 1 : -1, 0, true};
    }

    std::priority_queue<HeapEntry, std::vector<HeapEntry>,
                        std::greater<HeapEntry>> heap;
    for (int i = 0; i + 1 < len; ++i) {
        if (boundary[i + 1]) continue;
        int32_t r = pair_rank(e, text, parts[i], parts[i + 1]);
        if (r >= 0) heap.push({r, i, 0, parts[i + 1].start, 0});
    }

    while (!heap.empty()) {
        HeapEntry top = heap.top();
        heap.pop();
        Part& a = parts[top.left];
        // exact identity: both sides unchanged since the entry was
        // pushed (either side growing through a merge bumps its version)
        if (!a.alive || a.version != top.left_version || a.next < 0)
            continue;
        Part& b = parts[a.next];
        if (b.start != top.right_start || b.version != top.right_version)
            continue;

        // merge b into a
        a.len += b.len;
        a.version++;
        b.alive = false;
        a.next = b.next;
        if (b.next >= 0) parts[b.next].prev = top.left;

        if (a.prev >= 0 && !boundary[a.start]) {
            Part& p = parts[a.prev];
            int32_t pr = pair_rank(e, text, p, a);
            if (pr >= 0)
                heap.push({pr, a.prev, p.version, a.start, a.version});
        }
        if (a.next >= 0 && !boundary[parts[a.next].start]) {
            Part& n = parts[a.next];
            int32_t nr = pair_rank(e, text, a, n);
            if (nr >= 0)
                heap.push({nr, top.left, a.version, n.start, n.version});
        }
    }

    int n = 0;
    for (int i = 0; i >= 0; i = parts[i].next) {
        const Part& p = parts[i];
        std::string key(reinterpret_cast<const char*>(text + p.start), p.len);
        auto it = e->ranks.find(key);
        if (it != e->ranks.end()) {
            if (n >= out_cap) return -1;
            out[n++] = it->second;
        } else {
            // unmergeable span without a rank: emit known single bytes
            for (uint32_t j = 0; j < p.len; ++j) {
                std::string one(reinterpret_cast<const char*>(
                                    text + p.start + j), 1);
                auto bit = e->ranks.find(one);
                if (bit != e->ranks.end()) {
                    if (n >= out_cap) return -1;
                    out[n++] = bit->second;
                }
            }
        }
    }
    return n;
}

int bpe_encode(void* h, const uint8_t* text, int len, int32_t* out,
               int out_cap) {
    return bpe_encode_bounded(h, text, len, nullptr, 0, out, out_cap);
}

void bpe_destroy(void* h) { delete static_cast<Encoder*>(h); }

}  // extern "C"
