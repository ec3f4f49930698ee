"""The ``.cnfrec`` array-record dataset format (port of the JAX
``data/records.py``; the replacement for the reference's TFRecords,
create_tfrecords.py:1-409).

The reference serializes every image as a protobuf Example with raw-bytes
features and reads them back with a per-record parse op
(conv_cINN_base_functions.py:26-65). This format stores ONE contiguous,
aligned ndarray blob per file plus a JSON header, so the reader is a
zero-copy ``np.memmap``. Layout, byte for byte the JAX package's (a file
written by either package reads the same in the other):

    [8B magic "CNFREC01"][8B LE header length][header JSON][pad to 64][blob]

Header keys: dtype (``dtype.str``), shape (per record), count, label (an
optional class id), extra (a free-form dict) and crc32 (zlib's, of the
blob; the reference's verify step, create_tfrecords.py:366-400).

Files follow the reference's dataset conventions (create_tfrecords.py:54-67):
one combined file for SR training, one file per class for class-conditional
training. ``data/native_loader.py`` reads the same files through the C++
loader.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Optional, Sequence

import numpy as np

MAGIC = b"CNFREC01"
_ALIGN = 64


def write_records(
    path: str,
    array: np.ndarray,
    *,
    label: Optional[int] = None,
    extra: Optional[Dict] = None,
    with_crc: bool = True,
):
    """Write ``array`` of shape (count, *record_shape) as one record file."""
    array = np.ascontiguousarray(array)
    # one zero-copy view for both the CRC and the write
    blob = memoryview(array).cast("B")
    header = {
        "dtype": array.dtype.str,
        "shape": list(array.shape[1:]),
        "count": int(array.shape[0]),
        "label": label,
        "extra": extra or {},
        "crc32": zlib.crc32(blob) if with_crc else None,
    }
    hbytes = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(hbytes).to_bytes(8, "little"))
        f.write(hbytes)
        pos = len(MAGIC) + 8 + len(hbytes)
        f.write(b"\0" * (-pos % _ALIGN))
        f.write(blob)


def read_header(path: str) -> Dict:
    """The JSON header, plus ``_data_offset``, the blob's byte offset."""
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise IOError(f"{path}: not a CNFREC01 file")
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen).decode())
    header["_data_offset"] = (8 + 8 + hlen) + (-(8 + 8 + hlen) % _ALIGN)
    return header


def read_records(path: str, *, mmap: bool = True, verify: bool = False) -> np.ndarray:
    """The record blob, (count, *record_shape); a read-only memory map by
    default. ``verify`` checks the stored CRC32 and raises on a mismatch."""
    header = read_header(path)
    shape = (header["count"], *header["shape"])
    dtype = np.dtype(header["dtype"])
    if mmap:
        arr = np.memmap(path, dtype=dtype, mode="r", offset=header["_data_offset"],
                        shape=shape)
    else:
        with open(path, "rb") as f:
            f.seek(header["_data_offset"])
            arr = np.frombuffer(f.read(), dtype=dtype).reshape(shape)
    if verify and header.get("crc32") is not None:
        if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != header["crc32"]:
            raise IOError(f"{path}: CRC mismatch")
    return arr


def class_file(directory: str, split: str, label: int) -> str:
    """Per-class file naming (the reference's one file per class for
    class-conditional training, create_tfrecords.py:64-67)."""
    return os.path.join(directory, f"{split}_class{label}.cnfrec")


def combined_file(directory: str, split: str) -> str:
    return os.path.join(directory, f"{split}_combined.cnfrec")


def write_class_sorted_dataset(
    directory: str,
    split: str,
    images: np.ndarray,
    labels: np.ndarray,
    which_classes: Sequence[int],
    combined: bool,
):
    """Write the dataset files of (images, labels): one combined file, or
    one file per class, images as float32 (N, H, W, D) in their order in
    ``images`` (the reference's offline stage, create_tfrecords.py:295-364).
    Returns the paths written."""
    os.makedirs(directory, exist_ok=True)
    images = np.asarray(images, np.float32)
    if images.ndim == 3:
        images = images[..., None]
    written = []
    if combined:
        mask = np.isin(labels, which_classes)
        path = combined_file(directory, split)
        write_records(path, images[mask], extra={"classes": list(map(int, which_classes))})
        written.append(path)
    else:
        for c in which_classes:
            path = class_file(directory, split, int(c))
            write_records(path, images[labels == c], label=int(c))
            written.append(path)
    return written


def verify_records(paths: Sequence[str]) -> Dict[str, Dict]:
    """CRC and shape check of each file (the reference's visual verify,
    create_tfrecords.py:366-400, without the images): count, record shape,
    min and max."""
    out = {}
    for p in paths:
        arr = read_records(p, verify=True)
        out[p] = {
            "count": arr.shape[0],
            "shape": arr.shape[1:],
            "min": float(arr.min()) if arr.size else None,
            "max": float(arr.max()) if arr.size else None,
        }
    return out
