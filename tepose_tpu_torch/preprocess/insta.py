"""Build the InstaVariety DB (`insta_train_db.h5`) — TensorFlow-free.

Port of `tools/preprocess/insta.py` (ref: lib/data_utils/insta_utils.py:
102-393): reads the InstaVariety tfrecord shards (per-frame jpeg images +
25-joint 'insta' keypoints), derives keypoint bboxes, extracts ResNet
features on the device, and appends everything to a single HDF5 through
`data.h5.H5Writer`, without h5py (the dataset is too large for one
in-memory dict; the writer holds one batch). The TFRecord /
SequenceExample codec below, decoder and encoder, is a byte-for-byte copy
of the tool's (tests/test_torch_preprocess.py holds it equal); the default
frame decoder's cv2 is imported by `decode_rgb`.

  python -m tepose_tpu_torch.preprocess.insta --dir data/insta_variety
         [--out PATH] [--no-verify-crc] [--gpu 0|cpu]
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp
import struct

import numpy as np
import torch

from tepose_tpu_torch.config import TePose_DB_DIR, gpu_device
from tepose_tpu_torch.data.h5 import H5Writer
from tepose_tpu_torch.data.preprocess import FeatureExtractor
from tepose_tpu_torch.ops.filters import kp_to_bbox_param
from tepose_tpu_torch.preprocess.common import (
    add_gpu_arg, load_backbone)

# ---------------------------------------------------------------------------
# TFRecord container framing (ref: tensorflow/core/lib/io/record_writer.cc;
# the format is public and stable: each record is
#   [u64le length][u32le masked_crc32c(length)][payload][u32le masked_crc(payload)]
# with CRC-32C (Castagnoli) and TF's rotate+offset masking.)
# ---------------------------------------------------------------------------

_CRC_TABLES = []  # slice-by-8: 8 lookup tables of 256 entries

def _find_crc32c_impl():
    """C-accelerated CRC-32C when a binding is importable (google_crc32c
    ships in this image); returns a bytes->int callable or None."""
    try:
        import google_crc32c  # type: ignore
        return google_crc32c.value
    except ImportError:
        pass
    try:
        import crc32c as _c  # type: ignore
        return _c.crc32c
    except ImportError:
        return None


_crc32c_impl = _find_crc32c_impl()


def _crc32c_tables():
    if not _CRC_TABLES:
        poly = 0x82F63B78  # reflected Castagnoli polynomial
        t0 = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            t0.append(c)
        _CRC_TABLES.append(t0)
        for k in range(1, 8):
            prev = _CRC_TABLES[k - 1]
            _CRC_TABLES.append(
                [(prev[i] >> 8) ^ t0[prev[i] & 0xFF] for i in range(256)])
    return _CRC_TABLES


def crc32c(data: bytes) -> int:
    if _crc32c_impl is not None:
        return int(_crc32c_impl(data)) & 0xFFFFFFFF
    t = _crc32c_tables()
    t0, t1, t2, t3, t4, t5, t6, t7 = t
    c = 0xFFFFFFFF
    n = len(data) & ~7
    # slice-by-8 (Intel's technique): one table hop per byte but only one
    # loop iteration per 8 bytes — ~6x the byte-at-a-time python loop
    words = struct.unpack(f"<{n // 8}Q", data[:n]) if n else ()
    for w in words:
        w ^= c
        c = (t7[w & 0xFF] ^ t6[(w >> 8) & 0xFF]
             ^ t5[(w >> 16) & 0xFF] ^ t4[(w >> 24) & 0xFF]
             ^ t3[(w >> 32) & 0xFF] ^ t2[(w >> 40) & 0xFF]
             ^ t1[(w >> 48) & 0xFF] ^ t0[(w >> 56) & 0xFF])
    for b in data[n:]:
        c = t0[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15 | c << 17) + 0xA282EAD8) & 0xFFFFFFFF


def iter_tfrecord(path: str, verify_crc: bool = True):
    """Yield record payloads from a TFRecord file, verifying the masked
    CRC-32C of both the length word and the payload (corrupt shards fail
    loudly instead of decoding garbage keypoints; pass verify_crc=False
    to skip the checksums on trusted shards)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise IOError(f"{path}: truncated record header")
            length, len_crc = struct.unpack("<QI", header)
            if verify_crc and _masked_crc(header[:8]) != len_crc:
                raise IOError(f"{path}: length crc mismatch")
            payload = f.read(length)
            crc_bytes = f.read(4)
            if len(payload) < length or len(crc_bytes) < 4:
                raise IOError(f"{path}: truncated record payload")
            (data_crc,) = struct.unpack("<I", crc_bytes)
            if verify_crc and _masked_crc(payload) != data_crc:
                raise IOError(f"{path}: payload crc mismatch")
            yield payload


def write_tfrecord(path: str, payloads) -> None:
    """Write serialized messages as a TFRecord file (same framing TF emits;
    round-trip partner of iter_tfrecord, used by the synthetic-shard tests)."""
    with open(path, "wb") as f:
        for p in payloads:
            header = struct.pack("<Q", len(p))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(p)
            f.write(struct.pack("<I", _masked_crc(p)))


# ---------------------------------------------------------------------------
# Protobuf wire format: decoder + encoder for the tf.train.SequenceExample
# subset InstaVariety uses (BytesList/FloatList/Int64List features).
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int):
    shift = 0
    out = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one protobuf message.
    Only wire types 0 (varint), 2 (length-delimited) and 5 (32-bit) appear
    in tf.train protos."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_feature(buf: bytes):
    """tf.train.Feature -> list of bytes / np.float32 / np.int64 values."""
    for field, wt, val in _iter_fields(buf):
        if field == 1:      # BytesList { repeated bytes value = 1; }
            return [v for f, _, v in _iter_fields(val) if f == 1]
        if field == 2:      # FloatList { repeated float value = 1 [packed]; }
            out = []
            for f, w, v in _iter_fields(val):
                if f != 1:
                    continue
                # packed (wire 2) or unpacked 32-bit (wire 5) — same bytes
                out.append(np.frombuffer(v, "<f4"))
            return np.concatenate(out) if out else np.zeros(0, np.float32)
        if field == 3:      # Int64List, packed varints
            out = []
            for f, w, v in _iter_fields(val):
                if f != 1:
                    continue
                if w == 2:
                    p = 0
                    while p < len(v):
                        x, p = _read_varint(v, p)
                        out.append(x)
                else:
                    out.append(v)
            # int64 rides the wire as an unsigned varint (two's complement
            # for negatives, matching _varint_bytes on the encode side)
            out = [x - (1 << 64) if x >= (1 << 63) else x for x in out]
            return np.asarray(out, np.int64)
    return []


def parse_sequence_example(raw: bytes):
    """tf.train.SequenceExample decoder (wire format only — no tensorflow).
    Returns {key: [per-step feature values]} for the feature_lists map;
    context features are ignored (the InstaVariety reader only needs the
    per-step lists)."""
    feature_lists = {}
    for field, _, val in _iter_fields(raw):
        if field != 2:  # SequenceExample.feature_lists
            continue
        for f2, _, entry in _iter_fields(val):
            if f2 != 1:  # FeatureLists.feature_list map entry
                continue
            key, flist = None, []
            for f3, _, v3 in _iter_fields(entry):
                if f3 == 1:
                    key = v3.decode()
                elif f3 == 2:  # FeatureList { repeated Feature feature = 1 }
                    for f4, _, v4 in _iter_fields(v3):
                        if f4 == 1:
                            flist.append(_parse_feature(v4))
            if key is not None:
                feature_lists[key] = flist
    return feature_lists


# Backwards-compatible alias (pre-r4 name).
parse_sequence_example_py = parse_sequence_example


def _varint_bytes(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # int64 two's complement, 10-byte varint
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    """One length-delimited (wire type 2) field."""
    return _varint_bytes(field << 3 | 2) + _varint_bytes(len(payload)) \
        + payload


def feature_bytes(values) -> bytes:
    """tf.train.Feature holding a BytesList."""
    return _ld(1, b"".join(_ld(1, v) for v in values))


def feature_floats(arr) -> bytes:
    """tf.train.Feature holding a packed FloatList."""
    packed = np.asarray(arr, "<f4").reshape(-1).tobytes()
    return _ld(2, _ld(1, packed))


def feature_ints(values) -> bytes:
    """tf.train.Feature holding a packed Int64List."""
    packed = b"".join(_varint_bytes(int(v))
                      for v in np.asarray(values).reshape(-1))
    return _ld(3, _ld(1, packed))


def serialize_sequence_example(feature_lists: dict,
                               context: dict = None) -> bytes:
    """Encode a tf.train.SequenceExample. `feature_lists` maps key -> list of
    already-encoded Features (one per step, from feature_bytes/floats/ints);
    `context` maps key -> one encoded Feature. Byte-compatible with
    tensorflow's serializer for this subset (pinned in tests)."""
    out = b""
    if context:
        ctx = b"".join(_ld(1, _ld(1, k.encode()) + _ld(2, f))
                       for k, f in context.items())
        out += _ld(1, ctx)
    fls = b"".join(
        _ld(1, _ld(1, key.encode())
            + _ld(2, b"".join(_ld(1, f) for f in feats)))
        for key, feats in feature_lists.items())
    return out + _ld(2, fls)


def _parse_example(raw: bytes):
    """Decode one InstaVariety SequenceExample: jpeg frames + (T, 25, 3)
    keypoints ('insta' format, ref: insta_utils.py:102-200)."""
    fl = parse_sequence_example(raw)
    if "image/encoded" not in fl:
        return None, None
    frames = [v[0] for v in fl["image/encoded"]]
    T = len(frames)
    xys = np.stack([np.asarray(v, np.float32)
                    for v in fl["image/xys"]]).reshape(
        T, 2, -1).transpose(0, 2, 1)
    vis = np.stack([np.asarray(v, np.int64)
                    for v in fl["image/vis"]]).reshape(T, -1, 1)
    kps = np.concatenate([xys, vis.astype(np.float32)], axis=2)
    return frames, kps


def decode_rgb(buf: bytes) -> np.ndarray:
    """An encoded (jpeg) frame as RGB uint8 (H, W, 3), decoded by OpenCV as
    the JAX builder decodes it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "decoding InstaVariety frames needs OpenCV (cv2), which is not "
            "installed: pass read_data a `decode` callable that returns an "
            "RGB uint8 (H, W, 3) array for an encoded frame") from e
    return cv2.imdecode(np.frombuffer(buf, np.uint8),
                        cv2.IMREAD_COLOR)[:, :, ::-1]


def read_data(folder: str, out_path: str = None, backbone=None,
              mesh=None, verify_crc: bool = True, *,
              device: torch.device | str = "cuda", decode=None) -> str:
    """Write `out_path` (default `<TEPOSE_DB_DIR>/insta_train_db.h5`).
    `backbone` defaults to the converted SPIN ResNet-50 on `device`,
    `decode(bytes)` to OpenCV (RGB uint8); `mesh` splits each feature
    batch over its devices."""
    decode = decode or decode_rgb
    extractor = FeatureExtractor(backbone if backbone is not None
                                 else load_backbone(device), mesh=mesh)
    out_path = out_path or osp.join(TePose_DB_DIR, "insta_train_db.h5")
    records = sorted(glob.glob(osp.join(folder, "train", "*.tfrecord")))
    if not records:
        raise FileNotFoundError(f"no tfrecords under {folder}/train")

    with H5Writer(out_path) as h5:
        append = h5.append
        for ri, rec_path in enumerate(records):
            for vi, raw in enumerate(iter_tfrecord(rec_path, verify_crc)):
                frames, kps = _parse_example(raw)
                if frames is None or len(frames) < 8:
                    continue
                bboxes, keep = [], []
                for t in range(len(frames)):
                    p = kp_to_bbox_param(kps[t], vis_thresh=0.3)
                    if p is None:
                        continue
                    side = 150.0 / p[2] * 1.2
                    bboxes.append([p[0], p[1], side, side])
                    keep.append(t)
                if len(keep) < 8:
                    continue
                imgs = [decode(frames[t]) for t in keep]
                feats = extractor.extract_from_frames(
                    imgs, np.asarray(bboxes, np.float32), scale=1.2)
                n = len(keep)
                vid = f"insta_{ri:04d}_{vi:04d}"
                append("vid_name", np.array([vid.encode()] * n))
                append("frame_id", np.asarray(keep))
                append("joints2D", kps[keep].astype(np.float32))
                append("bbox", np.asarray(bboxes, np.float32))
                append("features", feats)
            print(f"{rec_path} done")
    print(f"wrote {out_path}")
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="data/insta_variety")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-verify-crc", action="store_true",
                    help="skip the per-record CRC-32C checks (the pure-"
                         "python CRC costs CPU time on multi-GB shard "
                         "sets; safe for shards you trust)")
    add_gpu_arg(ap)
    args = ap.parse_args(argv)
    read_data(args.dir, args.out, verify_crc=not args.no_verify_crc,
              device=gpu_device(args.gpu))


if __name__ == "__main__":
    main()
