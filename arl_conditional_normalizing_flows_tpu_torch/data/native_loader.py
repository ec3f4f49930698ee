"""``ctypes`` wrapper over the C++ record loader ``native/cnfrec_loader.cc``
at the repository root (port of the JAX ``data/native_loader.py``), and the
streaming class and SR sources built on it.

The native layer does what the reference gets from TensorFlow's C++ runtime
(TFRecord reading and parsing, conv_cINN_base_functions.py:26-65): a
zero-copy mmap of a ``.cnfrec`` blob, a threaded batch gather, and the CRC32
and CRC32C checks. ``build.load_host_library`` compiles it with ``g++`` into
the port's git-ignored ``_build/``, keyed by a hash of the source and the
flags, at first use. A failed build raises with the compiler's stderr:
there is no quiet fallback to a Python reader. ``records.read_records(path)
[indices]`` is the plain version the tests hold the gather to.

:class:`StreamingClassSource` and :class:`StreamingSRSource` yield, for one
``torch.Generator`` state, the batches of the in-RAM ``ClassConditionalSource``
and ``SRSource`` (``data/images.py``): they make the same draws in the same
order on the same generator. Only the main thread touches the generator and
the device. An epoch's permutations are drawn on the generator's device and
moved to the host once; a prefetch thread then gathers the host rows of the
batches ahead (fresh arrays, so nothing is overwritten while in use) and
turns them into the host batch (``logitify_np``, or ``preprocess_sr`` on the
CPU, as the in-RAM sources build theirs); the main thread copies each batch
to the device synchronously, adds the label plane, and draws the noise, in
batch order.
"""

from __future__ import annotations

import ctypes
import json
import os
import queue
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import build
from arl_conditional_normalizing_flows_tpu_torch.ops.logit import logitify_np

#: the C++ source, at the repository root (the JAX package's too)
SOURCE = build.PACKAGE_DIR.parent / "native" / "cnfrec_loader.cc"
#: threads of one native gather (the loader copies rows single-threaded
#: below 256 of them)
GATHER_THREADS = min(8, os.cpu_count() or 1)
#: batches of host rows the streaming sources gather ahead
PREFETCH = 2


def load_library() -> ctypes.CDLL:
    """The loader library, built with ``g++`` where needed; raises when the
    build fails."""
    lib = build.load_host_library(SOURCE)
    lib.cnf_open.restype = ctypes.c_void_p
    lib.cnf_open.argtypes = [ctypes.c_char_p]
    lib.cnf_close.restype = None
    lib.cnf_close.argtypes = [ctypes.c_void_p]
    lib.cnf_count.restype = ctypes.c_int64
    lib.cnf_count.argtypes = [ctypes.c_void_p]
    lib.cnf_header_json.restype = ctypes.c_char_p
    lib.cnf_header_json.argtypes = [ctypes.c_void_p]
    lib.cnf_verify_crc.restype = ctypes.c_int
    lib.cnf_verify_crc.argtypes = [ctypes.c_void_p]
    lib.cnf_gather.restype = None
    lib.cnf_gather.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                               ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
    lib.cnf_gather_multi.restype = None
    lib.cnf_gather_multi.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.POINTER(ctypes.c_int32),
                                     ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_int]
    lib.cnf_crc32c.restype = ctypes.c_uint32
    lib.cnf_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    return lib


def reader_name() -> str:
    """What reads the records: the native loader and its build."""
    return f"native loader {build.host_library_path(SOURCE).name} (g++, {SOURCE.name})"


def crc32c_native(data: bytes) -> int:
    """CRC32C (Castagnoli) of ``data``, by the native loader."""
    data = bytes(data)
    return int(load_library().cnf_crc32c(data, len(data)))


class NativeRecordFile:
    """One open ``.cnfrec`` file, memory-mapped by the native loader."""

    def __init__(self, path: str, verify: bool = False):
        self.path = path
        self._lib = load_library()
        self._h = self._lib.cnf_open(os.fsencode(path))
        if not self._h:
            raise IOError(f"cnf_open failed for {path} (missing, truncated or not CNFREC01)")
        self.header = json.loads(self._lib.cnf_header_json(self._h).decode())
        if verify and not self._lib.cnf_verify_crc(self._h):
            self.close()
            raise IOError(f"{path}: CRC mismatch")
        self.count = int(self.header["count"])
        self.record_shape = tuple(self.header["shape"])
        self.dtype = np.dtype(self.header["dtype"])

    def _check_open(self):
        if self._h is None:
            raise ValueError(f"gather on closed NativeRecordFile {self.path}")

    def gather(self, indices, out: Optional[np.ndarray] = None) -> np.ndarray:
        """``records[indices]`` as a new contiguous array (or into ``out``)."""
        self._check_open()
        indices = np.ascontiguousarray(indices, np.int64)
        # the native memcpy has no bounds check
        if len(indices) and (indices.min() < 0 or indices.max() >= self.count):
            raise IndexError(f"record indices out of range [0, {self.count}) for {self.path}")
        n = len(indices)
        shape = (n,) + self.record_shape
        if out is None:
            out = np.empty(shape, self.dtype)
        elif out.shape != shape or out.dtype != self.dtype or not out.flags.c_contiguous:
            raise ValueError(f"out must be a contiguous {self.dtype} array of shape {shape}")
        self._lib.cnf_gather(self._h, indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                             n, out.ctypes.data_as(ctypes.c_void_p), GATHER_THREADS)
        return out

    def close(self):
        if self._h is not None:
            self._lib.cnf_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self.close()


def gather_multi(files: Sequence[NativeRecordFile], file_ids, indices) -> np.ndarray:
    """``files[file_ids[i]].records[indices[i]]`` for each i, in one native
    call. The files must share record shape and dtype."""
    file_ids = np.ascontiguousarray(file_ids, np.int32)
    indices = np.ascontiguousarray(indices, np.int64)
    closed = [f.path for f in files if f._h is None]
    if closed:
        raise ValueError(f"gather_multi on closed NativeRecordFile(s): {closed}")
    f0 = files[0]
    for f in files[1:]:
        # the output stride is uniform: mixed shapes would write out of bounds
        if f.record_shape != f0.record_shape or f.dtype != f0.dtype:
            raise ValueError(
                "gather_multi needs identical record shapes/dtypes: "
                f"{f0.path}={f0.record_shape}/{f0.dtype} vs {f.path}={f.record_shape}/{f.dtype}")
    n = len(indices)
    if len(file_ids) != n:
        raise ValueError(f"{len(file_ids)} file ids for {n} indices")
    if n:
        counts = np.asarray([f.count for f in files], np.int64)
        if int(file_ids.min()) < 0 or int(file_ids.max()) >= len(files):
            raise IndexError(f"file_ids out of range [0, {len(files)})")
        if (indices < 0).any() or (indices >= counts[file_ids]).any():
            raise IndexError("record indices out of range for their files")
    out = np.empty((n,) + f0.record_shape, f0.dtype)
    handles = (ctypes.c_void_p * len(files))(*[f._h for f in files])
    f0._lib.cnf_gather_multi(handles, file_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                             indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
                             out.ctypes.data_as(ctypes.c_void_p), GATHER_THREADS)
    return out


def _prefetched(schedule, assemble):
    """Yield ``assemble(item)`` for each item of ``schedule``, computed by a
    background thread at most :data:`PREFETCH` items ahead (the tf.data prefetch
    role, conv_cINN.py:328-329). A consumer that stops early stops and reaps
    the thread; an exception in ``assemble`` is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
    stop = threading.Event()
    done = object()

    def put(item):
        # bounded put: an abandoned consumer must not leave the thread
        # blocked on a full queue, holding the batches and the files
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in schedule:
                if not put((True, assemble(item))):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            put((False, e))
            return
        put((True, done))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            ok, item = q.get()
            if not ok:
                raise item
            if item is done:
                break
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)


class PrefetchingEpochLoader:
    """Double-buffered host feeder of one file: a background thread gathers
    the next batch of rows while the caller works on the current one."""

    def __init__(self, file: NativeRecordFile, batch_size: int):
        self.file = file
        self.batch_size = batch_size

    def epoch(self, order):
        """Yield ``records[order[i*B:(i+1)*B]]`` for each full batch."""
        order = np.asarray(order, np.int64)
        b = self.batch_size
        yield from _prefetched(range(len(order) // b),
                               lambda i: self.file.gather(order[i * b:(i + 1) * b]))


class StreamingClassSource:
    """Bounded-memory counterpart of ``data.images.ClassConditionalSource``
    over per-class ``.cnfrec`` files (``records.class_file``): the same
    class-pure batches for the same generator, gathered on demand, with at
    most :data:`PREFETCH` batches of host rows ahead. ``logitify_np`` is applied
    per gathered batch (it is per-element, so the values are the in-RAM
    source's)."""

    def __init__(self, paths, which_classes, batch_size, use_logits=False, logit_a=0.01,
                 noise_floor_alpha=0.98):
        from arl_conditional_normalizing_flows_tpu_torch.data.images import class_labels_01

        self.which_classes = [int(c) for c in which_classes]
        self.batch_size = int(batch_size)
        self.use_logits = use_logits
        self.logit_a = logit_a
        self.noise_floor_alpha = noise_floor_alpha
        self.files = [NativeRecordFile(p) for p in paths]
        if len(self.files) != len(self.which_classes):
            raise ValueError(f"{len(self.files)} files for classes {self.which_classes}")
        self._label_values = class_labels_01(len(self.which_classes))
        b = self.batch_size
        # per-class truncation to whole class-pure batches (conv_cINN.py:271-304)
        self._counts = [(f.count // b) * b for f in self.files]
        if not all(self._counts):
            raise ValueError(
                "a class file has fewer records than batch_size - it would contribute ZERO "
                f"class-pure batches (per-class truncation, conv_cINN.py:271-304); "
                f"per-class counts: {[f.count for f in self.files]}, batch_size={b}")
        self._first_slot = np.cumsum([0] + [c // b for c in self._counts])
        self.num_batches = int(self._first_slot[-1])
        shape = self.files[0].record_shape
        self.xy_shape = (shape[0], shape[1], (shape[2] if len(shape) > 2 else 1) + 1)

    def _slot_class(self, slot: int):
        ci = int(np.searchsorted(self._first_slot, slot, side="right")) - 1
        return ci, slot - int(self._first_slot[ci])

    def epoch(self, generator):
        """Yield the epoch's class-pure xy batches ``(B, H, W, D + 1)`` on the
        generator's device: the draws of ``ClassConditionalSource.epoch`` in
        its order (the slot order, one permutation a class, then one noise
        draw a batch)."""
        device = generator.device
        b = self.batch_size
        h, w = self.xy_shape[:2]
        order = torch.randperm(self.num_batches, generator=generator, device=device)
        perms = [torch.randperm(n, generator=generator, device=device) for n in self._counts]
        # one move to the host an epoch; the thread reads only these
        flat = torch.cat([order, *perms]).cpu().numpy()
        order = flat[:self.num_batches]
        perms = np.split(flat[self.num_batches:], np.cumsum(self._counts)[:-1])

        def assemble(slot):
            ci, local = self._slot_class(int(slot))
            x = self.files[ci].gather(perms[ci][local * b:(local + 1) * b])
            x = x.reshape((b, h, w, -1)).astype(np.float32, copy=False)
            if self.use_logits:
                x = logitify_np(x, self.logit_a)
            return ci, x

        a = self.noise_floor_alpha
        for ci, x in _prefetched(order, assemble):
            x = torch.from_numpy(x).to(device)
            yplane = torch.full((b, h, w, 1), float(self._label_values[ci]), device=device)
            xy = torch.cat([x, yplane], dim=-1)
            if a < 1.0:
                eps = torch.randn(xy.shape, generator=generator, dtype=xy.dtype, device=device)
                xy = a * xy + (1 - a) * eps
            yield xy

    def close(self):
        for f in self.files:
            f.close()


class StreamingSRSource:
    """Bounded-memory counterpart of ``data.images.SRSource`` over a
    combined ``.cnfrec`` file (``records.combined_file``): the same example
    permutation and noise for the same generator; each batch's high-res rows
    are gathered ahead by the prefetch thread and turned into the SR pair by
    ``preprocess_sr`` on the CPU, as the in-RAM source builds its pairs (per
    example, so its values)."""

    def __init__(self, path, model_type, batch_size, residual=True, noise_floor_alpha=0.98):
        self.file = NativeRecordFile(path)
        self.model_type = model_type
        self.batch_size = int(batch_size)
        self.residual = residual
        self.noise_floor_alpha = noise_floor_alpha
        n = (self.file.count // self.batch_size) * self.batch_size
        if n == 0:
            raise ValueError(f"dataset ({self.file.count} examples) smaller than batch_size "
                             f"({self.batch_size}) - zero batches")
        self._n = n
        self.num_batches = n // self.batch_size
        h, w = self.file.record_shape[:2]
        d = self.file.record_shape[2] if len(self.file.record_shape) > 2 else 1
        if model_type == "SR4,2":
            h, w = h // 2, w // 2
        elif model_type != "SR2,1":
            raise ValueError(f"unknown SR model_type {model_type!r}")
        self.xy_shape = (h, w, 2 * d)

    def epoch(self, generator):
        """Yield the epoch's xy batches ``(B, H, W, 2 D)`` on the generator's
        device: the draws of ``SRSource.epoch`` in its order (the example
        permutation, then one noise draw a batch)."""
        from arl_conditional_normalizing_flows_tpu_torch.data.images import preprocess_sr

        device = generator.device
        b = self.batch_size
        h0, w0 = self.file.record_shape[:2]
        order = torch.randperm(self._n, generator=generator, device=device).cpu().numpy()

        def assemble(i):
            idx = order[i * b:(i + 1) * b]
            # gather in file order for locality, then restore the batch order
            rows = self.file.gather(np.sort(idx))
            rows = rows[np.argsort(np.argsort(idx))]
            rows = rows.reshape((b, h0, w0, -1)).astype(np.float32, copy=False)
            return preprocess_sr(rows, self.model_type, self.residual)

        a = self.noise_floor_alpha
        for xy in _prefetched(range(self.num_batches), assemble):
            xy = xy.to(device)
            if a < 1.0:
                eps = torch.randn(xy.shape, generator=generator, dtype=xy.dtype, device=device)
                xy = a * xy + (1 - a) * eps
            yield xy

    def close(self):
        self.file.close()
