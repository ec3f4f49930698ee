"""Reader and writer for the reference's TFRecord dataset files, without
TensorFlow (port of the JAX ``data/tfrecord_compat.py``).

Users migrating from the reference bring ``.tfrecords`` files written by
create_tfrecords.py:197-250: each record is a protobuf ``Example`` whose
feature dict is {img: raw float32 bytes, height/width/depth: int64, label:
raw float32 bytes (one-hot)}. This module implements just enough of the
TFRecord framing (length-prefixed records with masked CRC32C) and of the
protobuf wire format to decode and encode those files with numpy only, plus
a converter to the native ``.cnfrec`` format.

TFRecord framing: [8B LE length][4B masked crc of length][data][4B masked crc
of data]. CRCs are checked when ``verify=True``. :func:`crc32c` is the C++
loader's (``data/native_loader.py``); :func:`crc32c_plain`, slice-by-8 over
Python ints, is its plain version.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — table-driven, for TFRecord frame verification
# ---------------------------------------------------------------------------

_CRC_TABLES = None


def _crc32c_tables():
    """8x256 slice-by-8 lookup tables as plain-int lists (np.uint32 scalar
    arithmetic is ~100x slower per op than Python ints)."""
    global _CRC_TABLES
    if _CRC_TABLES is None:
        poly = 0x82F63B78
        t0 = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (poly if c & 1 else 0)
            t0.append(c)
        tables = [t0]
        for _ in range(7):
            prev = tables[-1]
            tables.append([t0[prev[i] & 0xFF] ^ (prev[i] >> 8) for i in range(256)])
        _CRC_TABLES = tables
    return _CRC_TABLES


def crc32c(data: bytes) -> int:
    """CRC32C of ``data``, by the C++ loader (native/cnfrec_loader.cc,
    slice-by-8); raises when the loader cannot be built."""
    from arl_conditional_normalizing_flows_tpu_torch.data.native_loader import crc32c_native

    return crc32c_native(data)


def crc32c_plain(data: bytes) -> int:
    """CRC32C of ``data`` in Python: the plain version of :func:`crc32c`."""
    tabs = _crc32c_tables()
    t0, t1, t2, t3, t4, t5, t6, t7 = tabs
    crc = 0xFFFFFFFF
    n8 = len(data) // 8 * 8
    mv = memoryview(data)
    for i in range(0, n8, 8):
        w = int.from_bytes(mv[i : i + 8], "little") ^ crc
        crc = (
            t7[w & 0xFF]
            ^ t6[(w >> 8) & 0xFF]
            ^ t5[(w >> 16) & 0xFF]
            ^ t4[(w >> 24) & 0xFF]
            ^ t3[(w >> 32) & 0xFF]
            ^ t2[(w >> 40) & 0xFF]
            ^ t1[(w >> 48) & 0xFF]
            ^ t0[(w >> 56) & 0xFF]
        )
    for b in mv[n8:]:
        crc = t0[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def iter_tfrecord_frames(path: str, verify: bool = False) -> Iterator[bytes]:
    """Yield the raw record payloads of a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:])
            data = f.read(length)
            (data_crc,) = struct.unpack("<I", f.read(4))
            if verify and masked_crc32c(header[:8]) != len_crc:
                raise IOError(f"{path}: length CRC mismatch")
            if verify and masked_crc32c(data) != data_crc:
                raise IOError(f"{path}: data CRC mismatch")
            yield data


# ---------------------------------------------------------------------------
# minimal protobuf Example decoding
# ---------------------------------------------------------------------------


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = bytes(buf[pos : pos + 4])
            pos += 4
        elif wire == 1:  # 64-bit
            val = bytes(buf[pos : pos + 8])
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_example(record: bytes) -> Dict[str, object]:
    """Decode a tf.train.Example into {name: bytes | int-list | float-list}.

    Message graph: Example{1: Features{1: map<string, Feature>}};
    Feature{1: BytesList{1: bytes}, 2: FloatList{1: packed floats},
    3: Int64List{1: packed varints}}.
    """
    out: Dict[str, object] = {}
    for f, w, features in _iter_fields(memoryview(record)):
        if f != 1 or w != 2:
            continue
        for f2, w2, entry in _iter_fields(features):
            if f2 != 1 or w2 != 2:
                continue
            name = None
            value = None
            for f3, w3, v3 in _iter_fields(entry):
                if f3 == 1 and w3 == 2:
                    name = bytes(v3).decode()
                elif f3 == 2 and w3 == 2:
                    value = _parse_feature(v3)
            if name is not None:
                out[name] = value
    return out


def _parse_feature(buf: memoryview):
    """Feature{1: BytesList, 2: FloatList, 3: Int64List} — each of those is
    itself a message whose field 1 holds the (possibly packed) values."""
    for f, w, v in _iter_fields(buf):
        if f == 1 and w == 2:  # BytesList{1: bytes}
            for f2, w2, v2 in _iter_fields(v):
                if f2 == 1 and w2 == 2:
                    return bytes(v2)
        elif f == 2 and w == 2:  # FloatList{1: repeated float}
            floats: List[float] = []
            for f2, w2, v2 in _iter_fields(v):
                if f2 == 1 and w2 == 2:  # packed
                    floats.extend(np.frombuffer(bytes(v2), np.float32).tolist())
                elif f2 == 1 and w2 == 5:  # unpacked single
                    floats.append(struct.unpack("<f", v2)[0])
            return np.asarray(floats, np.float32)
        elif f == 3 and w == 2:  # Int64List{1: repeated int64}
            ints: List[int] = []
            for f2, w2, v2 in _iter_fields(v):
                if f2 == 1 and w2 == 2:  # packed varints
                    pos = 0
                    while pos < len(v2):
                        x, pos = _read_varint(v2, pos)
                        ints.append(x)
                elif f2 == 1 and w2 == 0:  # unpacked varint
                    ints.append(v2)
            return ints
    return None


# ---------------------------------------------------------------------------
# reference-format dataset reading
# ---------------------------------------------------------------------------


def read_reference_tfrecords(path: str, verify: bool = False):
    """Read one of the reference's image TFRecord files
    (create_tfrecords.py:197-250) into (images (N,H,W,D) float32,
    labels (N, num_classes) float32 one-hot)."""
    imgs: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    for rec in iter_tfrecord_frames(path, verify=verify):
        ex = parse_example(rec)
        h = int(ex["height"][0])
        w = int(ex["width"][0])
        d = int(ex["depth"][0])
        img = np.frombuffer(ex["img"], np.float32).reshape(h, w, d)
        imgs.append(img)
        lab = ex.get("label")
        if isinstance(lab, bytes):
            lab = np.frombuffer(lab, np.float32)
        labels.append(np.asarray(lab, np.float32) if lab is not None else np.zeros(0))
    return np.stack(imgs), np.stack(labels)


# ---------------------------------------------------------------------------
# reference-format dataset WRITING (byte-compatible with tf.io.TFRecordWriter
# + tf.train.Example — lets datasets built here feed the original codebase)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _bytes_feature(value: bytes) -> bytes:
    """Feature{1: BytesList{1: value}}."""
    return _len_delimited(1, _len_delimited(1, value))


def _int64_feature(value: int) -> bytes:
    """Feature{3: Int64List{1: varint}}."""
    return _len_delimited(3, _varint((1 << 3) | 0) + _varint(value))


def encode_example(features: Dict[str, bytes]) -> bytes:
    """tf.train.Example{1: Features{1: map<string, Feature>}} from
    already-encoded Feature payloads."""
    entries = b"".join(
        _len_delimited(1, _len_delimited(1, name.encode()) + _len_delimited(2, feat))
        for name, feat in features.items()
    )
    return _len_delimited(1, entries)


def write_tfrecord_frames(path: str, frames) -> int:
    """Write records with TFRecord framing (length + masked CRCs)."""
    n = 0
    with open(path, "wb") as f:
        for data in frames:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(data)
            f.write(struct.pack("<I", masked_crc32c(data)))
            n += 1
    return n


def write_reference_tfrecords(path: str, images: np.ndarray, labels: np.ndarray) -> int:
    """Write images/one-hot labels in the reference's exact TFRecord schema
    (create_tfrecords.py:197-250: raw-float32 ``img``/``label`` bytes plus
    int64 ``height``/``width``/``depth``), so files produced here are
    readable by the unmodified reference pipeline (its ``_parse_example``,
    conv_cINN_base_functions.py:26-65).

    Args:
        images: (N, H, W, D) float32 in [0, 1].
        labels: (N, num_classes) float32 one-hot.
    Returns the number of records written.
    """
    images = np.ascontiguousarray(images, np.float32)
    labels = np.ascontiguousarray(labels, np.float32)
    if images.ndim != 4 or len(images) != len(labels):
        raise ValueError(f"images (N, H, W, D) and one label row each: {images.shape}, "
                         f"{labels.shape}")
    _, h, w, d = images.shape

    def frames():
        for img, lab in zip(images, labels):
            yield encode_example(
                {
                    "img": _bytes_feature(img.tobytes()),
                    "height": _int64_feature(h),
                    "width": _int64_feature(w),
                    "depth": _int64_feature(d),
                    "label": _bytes_feature(lab.tobytes()),
                }
            )

    return write_tfrecord_frames(path, frames())


def convert_to_cnfrec(tfrecord_path: str, out_path: str, verify: bool = True):
    """Convert a reference TFRecord file to the native .cnfrec format."""
    from arl_conditional_normalizing_flows_tpu_torch.data import records

    imgs, labels = read_reference_tfrecords(tfrecord_path, verify=verify)
    label = None
    if labels.size and labels.shape[1] > 0:
        hot = labels.argmax(axis=1)
        if np.all(hot == hot[0]) and np.all(labels.sum(axis=1) == 1):
            label = int(hot[0])
    records.write_records(out_path, imgs, label=label)
    return imgs.shape
