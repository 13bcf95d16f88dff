// The document store's write path in one pass: the port's copy of
// ``vbl_doc_store_body`` (native/baseline.cpp), built into the port's native
// library beside native/indexer.cpp, whose LZ codec it calls. It splits an
// ndjson buffer into documents, packs them into ~16 KB blocks with per-block
// doc offsets and LZ-compresses each block (reference doc_store/src/lib.rs
// DocStoreWriter 84-166). Its body and index rows are byte-equal to the
// Python DocStoreWriter's with the LZ codec.

#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

extern "C" {
int64_t vl_lz_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap);
int64_t vl_lz_bound(int64_t n);

// Walk the ndjson buffer, split lines (a line is a document iff it has any
// non-whitespace), assemble blocks (offsets u32[n+1] + raw; flush AFTER a
// doc pushes the block past flush_threshold), LZ-compress each block and
// write the framed body: [codec u8][noffsets u32][payload_len u32][comp].
// index_rows receives (first_doc_id, start, end) per block. Returns the
// body size, or -1 if out_cap / max_blocks were insufficient.
int64_t vl_doc_store_body(const char* buf, int64_t len,
                          int32_t flush_threshold, uint8_t* out,
                          int64_t out_cap, uint64_t* index_rows,
                          int64_t max_blocks, int64_t* n_blocks_out,
                          int64_t* num_docs_out,
                          int64_t* bytes_indexed_out) {
    std::vector<std::pair<const char*, int64_t>> lines;  // current block
    std::vector<uint8_t> payload;
    std::vector<uint8_t> comp;
    int64_t pos = 0;            // write position in out
    int64_t n_blocks = 0;
    int64_t curr_id = 0;
    int64_t bytes_indexed = 0;
    int64_t block_bytes = 0;
    int64_t first_id_in_block = 0;

    auto flush = [&]() -> bool {
        if (lines.empty()) return true;
        size_t n = lines.size();
        payload.clear();
        payload.resize(4 * (n + 1));
        uint32_t off = 0;
        std::memcpy(payload.data(), &off, 4);
        for (size_t i = 0; i < n; ++i) {
            off += static_cast<uint32_t>(lines[i].second);
            std::memcpy(payload.data() + 4 * (i + 1), &off, 4);
        }
        for (size_t i = 0; i < n; ++i)
            payload.insert(payload.end(),
                           reinterpret_cast<const uint8_t*>(lines[i].first),
                           reinterpret_cast<const uint8_t*>(lines[i].first) +
                               lines[i].second);
        comp.resize(static_cast<size_t>(vl_lz_bound(
            static_cast<int64_t>(payload.size()))));
        int64_t clen = vl_lz_compress(payload.data(),
                                      static_cast<int64_t>(payload.size()),
                                      comp.data(),
                                      static_cast<int64_t>(comp.size()));
        if (clen < 0) return false;
        int64_t need = 1 + 4 + 4 + clen;
        if (pos + need > out_cap || n_blocks >= max_blocks) return false;
        int64_t start = pos;
        out[pos++] = 1;  // codec: native LZ
        uint32_t noffsets = static_cast<uint32_t>(n + 1);
        std::memcpy(out + pos, &noffsets, 4);
        pos += 4;
        uint32_t plen = static_cast<uint32_t>(payload.size());
        std::memcpy(out + pos, &plen, 4);
        pos += 4;
        std::memcpy(out + pos, comp.data(), static_cast<size_t>(clen));
        pos += clen;
        index_rows[n_blocks * 3 + 0] = static_cast<uint64_t>(first_id_in_block);
        index_rows[n_blocks * 3 + 1] = static_cast<uint64_t>(start);
        index_rows[n_blocks * 3 + 2] = static_cast<uint64_t>(pos);
        ++n_blocks;
        lines.clear();
        block_bytes = 0;
        return true;
    };

    int64_t i = 0;
    while (i < len) {
        int64_t start = i;
        while (i < len && buf[i] != '\n') ++i;
        int64_t line_len = i - start;
        if (i < len) ++i;  // skip the newline
        bool has_content = false;
        for (int64_t j = start; j < start + line_len; ++j) {
            unsigned char c = static_cast<unsigned char>(buf[j]);
            if (c != ' ' && c != '\t' && c != '\r' && c != '\n' && c != '\f' &&
                c != '\v') {
                has_content = true;
                break;
            }
        }
        if (!has_content) continue;
        if (lines.empty()) first_id_in_block = curr_id;
        lines.emplace_back(buf + start, line_len);
        block_bytes += line_len;
        bytes_indexed += line_len;
        ++curr_id;
        if (block_bytes > flush_threshold && !flush()) return -1;
    }
    if (!flush()) return -1;
    *n_blocks_out = n_blocks;
    *num_docs_out = curr_id;
    *bytes_indexed_out = bytes_indexed;
    return pos;
}
}  // extern "C"
