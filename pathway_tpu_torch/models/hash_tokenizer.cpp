// The hash tokenizer's ids for ASCII rows, in one pass over a batch's bytes.
//
// Each row is the bytes text[offsets[r] .. offsets[r + 1]). Its ids are the
// class id 1, then one id a word: a word is a run of [A-Za-z0-9], lower-cased
// and hashed with 64-bit FNV-1a into 2 + h % modulus. A row stops once it
// holds `cap` ids. This is HashTokenizer.tokenize in models/tokenizer.py
// (Python's lower() and its [a-z0-9] pattern agree with this on ASCII).
//
// ids and mask are row-major [n, width] with width >= cap, zeroed by the
// caller; a row's ids and a 1 in its mask go to its first count[r] places.
// The function keeps no state between calls.

#include <cstdint>

namespace {

constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ull;
constexpr uint64_t kFnvPrime = 0x100000001B3ull;

// byte -> the byte a word hashes (A-Z lower-cased), or 0 outside a word
struct WordBytes {
  uint8_t of[256] = {};
  constexpr WordBytes() {
    for (int c = '0'; c <= '9'; ++c) of[c] = static_cast<uint8_t>(c);
    for (int c = 'a'; c <= 'z'; ++c) of[c] = static_cast<uint8_t>(c);
    for (int c = 'A'; c <= 'Z'; ++c) of[c] = static_cast<uint8_t>(c - 'A' + 'a');
  }
};

constexpr WordBytes kWord;

}  // namespace

extern "C" void ht_rows(const uint8_t* text, const int64_t* offsets, int64_t n,
                        uint64_t modulus, int64_t cap, int64_t width,
                        int32_t* ids, int32_t* mask, int64_t* count) {
  for (int64_t r = 0; r < n; ++r) {
    const uint8_t* p = text + offsets[r];
    const uint8_t* const end = text + offsets[r + 1];
    int32_t* const row_ids = ids + r * width;
    int32_t* const row_mask = mask + r * width;
    row_ids[0] = 1;
    row_mask[0] = 1;
    int64_t k = 1;
    while (k < cap) {
      while (p < end && kWord.of[*p] == 0) ++p;
      if (p == end) break;
      uint64_t h = kFnvOffset;
      for (uint8_t b; p < end && (b = kWord.of[*p]) != 0; ++p) h = (h ^ b) * kFnvPrime;
      row_ids[k] = static_cast<int32_t>(2 + h % modulus);
      row_mask[k] = 1;
      ++k;
    }
    count[r] = k;
  }
}
