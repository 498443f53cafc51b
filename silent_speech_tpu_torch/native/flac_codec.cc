// FLAC decoder, the native path of the port's audio reads.
//
// Own copy of the JAX package's decoder (cpp/flac_codec.cc), with one
// change: reading past the end of the buffer is an error, never a zero.
// The reader flags any read past the end (ReadBits, ReadUnary, SkipBytes),
// and a stream that ends inside a metadata block, inside a frame, or
// before STREAMINFO's total_samples returns kTruncated, where the JAX copy
// returns what it decoded so far. A lost frame sync returns kLostSync,
// as the plain decoder (utils/flac.py read_flac_bytes) raises on it.
//
// Covers what standard encoders write: constant, verbatim, fixed and LPC
// subframes, Rice and Rice2 residual partitions, independent and
// left/right/mid-side stereo, 8 to 24 bits. Samples come out as float32
// over 2^(bps-1), which is exact up to 24 bits.
//
// C ABI (ctypes-bound in silent_speech_tpu_torch/utils/native.py):
//   ssp_flac_decode(data, len, *rate, *channels, **out) -> frames or < 0
//   ssp_free(ptr)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// error codes of ssp_flac_decode (utils/native.py FLAC_ERRORS)
constexpr int64_t kNotFlac = -1;
constexpr int64_t kNoStreamInfo = -2;
constexpr int64_t kBadBlockSize = -3;
constexpr int64_t kBadSampleSize = -4;
constexpr int64_t kBadSubframe = -5;
constexpr int64_t kBadChannels = -6;
constexpr int64_t kNoMemory = -7;
constexpr int64_t kTruncated = -8;
constexpr int64_t kLostSync = -9;

class BitReader {
 public:
  BitReader(const uint8_t* data, int64_t size, int64_t byte_pos = 0)
      : data_(data), size_(size), byte_pos_(byte_pos), bit_pos_(0),
        overrun_(false) {}

  // true once any read went past the end of the buffer
  bool overrun() const { return overrun_; }
  int64_t byte_pos() const { return byte_pos_; }

  uint64_t ReadBits(int n) {
    uint64_t result = 0;
    while (n > 0) {
      if (byte_pos_ >= size_) {
        overrun_ = true;
        return 0;
      }
      int avail = 8 - bit_pos_;
      int take = n < avail ? n : avail;
      int shift = avail - take;
      uint32_t bits = (data_[byte_pos_] >> shift) & ((1u << take) - 1);
      result = (result << take) | bits;
      bit_pos_ += take;
      if (bit_pos_ == 8) {
        bit_pos_ = 0;
        byte_pos_++;
      }
      n -= take;
    }
    return result;
  }

  int64_t ReadSigned(int n) {
    uint64_t v = ReadBits(n);
    if (n > 0 && (v >> (n - 1)) & 1) {
      return static_cast<int64_t>(v) - (int64_t(1) << n);
    }
    return static_cast<int64_t>(v);
  }

  int ReadUnary() {
    int count = 0;
    while (byte_pos_ < size_) {
      uint8_t byte = data_[byte_pos_];
      uint8_t remaining = byte & ((1u << (8 - bit_pos_)) - 1);
      if (remaining == 0) {
        count += 8 - bit_pos_;
        bit_pos_ = 0;
        byte_pos_++;
        continue;
      }
      int msb = 31 - __builtin_clz(remaining);  // highest set bit index
      int zeros = (8 - bit_pos_) - (msb + 1);
      count += zeros;
      bit_pos_ += zeros + 1;
      if (bit_pos_ >= 8) {
        bit_pos_ -= 8;
        byte_pos_++;
      }
      return count;
    }
    overrun_ = true;  // no terminating 1 bit before the end
    return count;
  }

  void AlignToByte() {
    if (bit_pos_) {
      bit_pos_ = 0;
      byte_pos_++;
    }
  }

  uint64_t ReadUtf8Number() {
    uint32_t first = static_cast<uint32_t>(ReadBits(8));
    if (first < 0x80) return first;
    int n_extra = 0;
    uint32_t mask = 0x40;
    while (first & mask) {
      n_extra++;
      mask >>= 1;
    }
    uint64_t value = first & (mask - 1);
    for (int i = 0; i < n_extra; i++) {
      value = (value << 6) | (ReadBits(8) & 0x3F);
    }
    return value;
  }

  void SkipBytes(int64_t n) {
    if (byte_pos_ + n > size_) overrun_ = true;
    byte_pos_ += n;
  }

 private:
  const uint8_t* data_;
  int64_t size_;
  int64_t byte_pos_;
  int bit_pos_;
  bool overrun_;
};

const int kBlocksizeTable[16] = {0,   192,  576,  1152, 2304, 4608, -1, -2,
                                 256, 512,  1024, 2048, 4096, 8192,
                                 16384, 32768};

bool DecodeResidual(BitReader& br, int blocksize, int predictor_order,
                    std::vector<int64_t>* residual) {
  int method = static_cast<int>(br.ReadBits(2));
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  int escape = (1 << param_bits) - 1;
  int partition_order = static_cast<int>(br.ReadBits(4));
  int n_partitions = 1 << partition_order;
  int samples_per_partition = blocksize >> partition_order;
  residual->clear();
  residual->reserve(blocksize - predictor_order);
  for (int p = 0; p < n_partitions && !br.overrun(); p++) {
    int count = samples_per_partition - (p == 0 ? predictor_order : 0);
    int param = static_cast<int>(br.ReadBits(param_bits));
    if (param == escape) {
      int raw_bits = static_cast<int>(br.ReadBits(5));
      for (int i = 0; i < count; i++) {
        residual->push_back(raw_bits ? br.ReadSigned(raw_bits) : 0);
      }
    } else {
      for (int i = 0; i < count && !br.overrun(); i++) {
        uint64_t q = br.ReadUnary();
        uint64_t r = param ? br.ReadBits(param) : 0;
        uint64_t v = (q << param) | r;
        residual->push_back((v >> 1) ^ -static_cast<int64_t>(v & 1));
      }
    }
  }
  // a cut stream stops early; a corrupt one may not fill the block
  return br.overrun() ||
         static_cast<int>(residual->size()) == blocksize - predictor_order;
}

const int kFixedCoeffs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool DecodeSubframe(BitReader& br, int blocksize, int bps,
                    std::vector<int64_t>* out) {
  if (br.ReadBits(1) != 0) return false;
  int sf_type = static_cast<int>(br.ReadBits(6));
  int wasted = 0;
  if (br.ReadBits(1)) {
    wasted = 1 + br.ReadUnary();
    bps -= wasted;
  }
  out->assign(blocksize, 0);
  std::vector<int64_t> residual;
  if (br.overrun()) return true;  // the caller reports the truncation

  if (sf_type == 0) {  // CONSTANT
    int64_t value = br.ReadSigned(bps);
    for (int i = 0; i < blocksize; i++) (*out)[i] = value;
  } else if (sf_type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; i++) (*out)[i] = br.ReadSigned(bps);
  } else if (sf_type >= 8 && sf_type <= 12) {  // FIXED
    int order = sf_type - 8;
    if (order > blocksize) return false;
    for (int i = 0; i < order; i++) (*out)[i] = br.ReadSigned(bps);
    if (!DecodeResidual(br, blocksize, order, &residual)) return false;
    if (br.overrun()) return true;
    for (int i = order; i < blocksize; i++) {
      int64_t pred = 0;
      for (int c = 0; c < order; c++) {
        pred += kFixedCoeffs[order][c] * (*out)[i - 1 - c];
      }
      (*out)[i] = pred + residual[i - order];
    }
  } else if (sf_type >= 32) {  // LPC
    int order = sf_type - 31;
    if (order > blocksize) return false;
    for (int i = 0; i < order; i++) (*out)[i] = br.ReadSigned(bps);
    int precision = static_cast<int>(br.ReadBits(4)) + 1;
    int shift = static_cast<int>(br.ReadSigned(5));
    if (shift < 0) return false;
    std::vector<int64_t> coeffs(order);
    for (int i = 0; i < order; i++) coeffs[i] = br.ReadSigned(precision);
    if (!DecodeResidual(br, blocksize, order, &residual)) return false;
    if (br.overrun()) return true;
    for (int i = order; i < blocksize; i++) {
      int64_t pred = 0;
      for (int c = 0; c < order; c++) {
        pred += coeffs[c] * (*out)[i - 1 - c];
      }
      (*out)[i] = (pred >> shift) + residual[i - order];
    }
  } else {
    return false;
  }
  if (wasted) {
    for (auto& v : *out) v <<= wasted;
  }
  return true;
}

// one decoded frame's status: kTruncated if the frame read past the end
int64_t Checked(const BitReader& br, int64_t code) {
  return br.overrun() ? kTruncated : code;
}

}  // namespace

extern "C" {

// Returns number of frames decoded (per channel), or a negative error code.
// *out is malloc'd interleaved float32, length n_frames * channels.
int64_t ssp_flac_decode(const uint8_t* data, int64_t len,
                        int32_t* sample_rate, int32_t* channels,
                        float** out) {
  if (len < 4 || memcmp(data, "fLaC", 4) != 0) return kNotFlac;
  int64_t pos = 4;
  int32_t rate = 0, n_channels = 0, bps = 0;
  uint64_t total_samples = 0;
  bool last = false;
  while (!last) {
    if (pos + 4 > len) return kTruncated;
    uint8_t header = data[pos];
    last = header & 0x80;
    int btype = header & 0x7F;
    int32_t length = (data[pos + 1] << 16) | (data[pos + 2] << 8)
                     | data[pos + 3];
    if (pos + 4 + length > len) return kTruncated;
    if (btype == 0) {  // STREAMINFO
      BitReader br(data + pos + 4, length);
      br.ReadBits(16); br.ReadBits(16); br.ReadBits(24); br.ReadBits(24);
      rate = static_cast<int32_t>(br.ReadBits(20));
      n_channels = static_cast<int32_t>(br.ReadBits(3)) + 1;
      bps = static_cast<int32_t>(br.ReadBits(5)) + 1;
      total_samples = br.ReadBits(36);
      if (br.overrun()) return kTruncated;
    }
    pos += 4 + length;
  }
  if (rate == 0 || n_channels == 0) return kNoStreamInfo;

  std::vector<float> samples;
  // a frame holds at most 65536 samples a channel in no fewer than 2 bytes
  if (total_samples) {
    samples.reserve(total_samples * n_channels < (uint64_t)len * 32768
                        ? total_samples * n_channels
                        : (uint64_t)len * 32768);
  }
  double scale = 1.0 / (double)(int64_t(1) << (bps - 1));
  uint64_t decoded = 0;

  std::vector<std::vector<int64_t>> chans(2);
  while (pos + 2 < len && (!total_samples || decoded < total_samples)) {
    BitReader br(data, len, pos);
    if (br.ReadBits(14) != 0x3FFE) return Checked(br, kLostSync);
    br.ReadBits(1);
    br.ReadBits(1);
    int bs_code = static_cast<int>(br.ReadBits(4));
    int sr_code = static_cast<int>(br.ReadBits(4));
    int ch_assign = static_cast<int>(br.ReadBits(4));
    int ss_code = static_cast<int>(br.ReadBits(3));
    br.ReadBits(1);
    br.ReadUtf8Number();

    int blocksize;
    if (bs_code == 6) blocksize = static_cast<int>(br.ReadBits(8)) + 1;
    else if (bs_code == 7) blocksize = static_cast<int>(br.ReadBits(16)) + 1;
    else blocksize = kBlocksizeTable[bs_code];
    if (br.overrun()) return kTruncated;
    if (blocksize <= 0) return kBadBlockSize;

    if (sr_code == 12) br.ReadBits(8);
    else if (sr_code == 13 || sr_code == 14) br.ReadBits(16);

    int fbps;
    switch (ss_code) {
      case 0: fbps = bps; break;
      case 1: fbps = 8; break;
      case 2: fbps = 12; break;
      case 4: fbps = 16; break;
      case 5: fbps = 20; break;
      case 6: fbps = 24; break;
      default: return Checked(br, kBadSampleSize);
    }
    br.ReadBits(8);  // CRC-8

    int nch;
    if (ch_assign < 8) {
      nch = ch_assign + 1;
      if (nch > (int)chans.size()) chans.resize(nch);
      for (int c = 0; c < nch; c++) {
        if (!DecodeSubframe(br, blocksize, fbps, &chans[c]))
          return Checked(br, kBadSubframe);
      }
    } else if (ch_assign == 8) {  // left/side
      nch = 2;
      if (!DecodeSubframe(br, blocksize, fbps, &chans[0]) ||
          !DecodeSubframe(br, blocksize, fbps + 1, &chans[1]))
        return Checked(br, kBadSubframe);
      for (int i = 0; i < blocksize; i++) chans[1][i] =
          chans[0][i] - chans[1][i];
    } else if (ch_assign == 9) {  // right/side
      nch = 2;
      if (!DecodeSubframe(br, blocksize, fbps + 1, &chans[0]) ||
          !DecodeSubframe(br, blocksize, fbps, &chans[1]))
        return Checked(br, kBadSubframe);
      for (int i = 0; i < blocksize; i++) chans[0][i] =
          chans[1][i] + chans[0][i];
    } else if (ch_assign == 10) {  // mid/side
      nch = 2;
      if (!DecodeSubframe(br, blocksize, fbps, &chans[0]) ||
          !DecodeSubframe(br, blocksize, fbps + 1, &chans[1]))
        return Checked(br, kBadSubframe);
      for (int i = 0; i < blocksize; i++) {
        int64_t mid = chans[0][i];
        int64_t side = chans[1][i];
        int64_t left = ((mid << 1) | (side & 1)) + side;
        chans[0][i] = left >> 1;
        chans[1][i] = (left - (side << 1)) >> 1;
      }
    } else {
      return Checked(br, kBadChannels);
    }

    br.AlignToByte();
    br.SkipBytes(2);  // CRC-16
    if (br.overrun()) return kTruncated;
    pos = br.byte_pos();

    int64_t take = blocksize;
    if (total_samples && decoded + take > total_samples) {
      take = total_samples - decoded;
    }
    for (int64_t i = 0; i < take; i++) {
      for (int c = 0; c < (n_channels < nch ? n_channels : nch); c++) {
        samples.push_back(static_cast<float>(chans[c][i] * scale));
      }
    }
    decoded += take;
  }
  if (total_samples && decoded < total_samples) return kTruncated;

  int64_t n_frames = samples.size() / n_channels;
  float* buf = static_cast<float*>(
      malloc((samples.size() ? samples.size() : 1) * sizeof(float)));
  if (!buf) return kNoMemory;
  memcpy(buf, samples.data(), samples.size() * sizeof(float));
  *out = buf;
  *sample_rate = rate;
  *channels = n_channels;
  return n_frames;
}

void ssp_free(void* p) { free(p); }

}  // extern "C"
