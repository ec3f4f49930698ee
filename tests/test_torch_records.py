"""The port's record path on the CPU: ``.cnfrec`` and reference TFRecord
files byte-equal to the JAX package's and read the same across the two;
CRC32C; the native loader (``native/cnfrec_loader.cc`` built with ``g++``
into ``_build/``) on every case of ``tests/test_native_loader.py``; the
streaming sources bit-equal to the port's in-RAM sources for one
``torch.Generator``; ``cnf-build-records`` against JAX's; and ``cnf-conv`` /
``cnf-eval`` with ``--records-dir``. The loader must build here: a missing
compiler fails these tests, it does not skip them."""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import few_threads  # noqa: E402,F401  (two torch threads, autouse)
from arl_conditional_normalizing_flows_tpu.data import records as jrecords  # noqa: E402
from arl_conditional_normalizing_flows_tpu.data import tfrecord_compat as jtfc  # noqa: E402
from arl_conditional_normalizing_flows_tpu.drivers import build_records as jbuild  # noqa: E402
from arl_conditional_normalizing_flows_tpu.drivers import conv as jconv  # noqa: E402
from arl_conditional_normalizing_flows_tpu.ops import logit as jlogit  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.data import native_loader  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.data import records  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.data import tfrecord_compat as tfc  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.data.images import (  # noqa: E402
    ClassConditionalSource,
    SRSource,
    synthetic_digits,
)
from arl_conditional_normalizing_flows_tpu_torch.drivers import build_records  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.drivers import conv, evaluate  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.ops import logit  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import build  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def record_file(tmp_path, rng):
    arr = rng.normal(size=(100, 6, 6, 2)).astype(np.float32)
    path = str(tmp_path / "t.cnfrec")
    records.write_records(path, arr, label=1)
    return path, arr


# ---------------------------------------------------------------------------
# .cnfrec and TFRecord files across the two packages
# ---------------------------------------------------------------------------

WRITE_CASES = [
    pytest.param(dict(label=3), (10, 4, 4, 1), np.float32, id="class"),
    pytest.param(dict(extra={"classes": [0, 1, 4]}), (7, 6, 6, 2), np.float32, id="combined"),
    pytest.param(dict(with_crc=False), (5, 3), np.float64, id="no_crc_float64"),
    pytest.param({}, (1, 28, 28, 1), np.float32, id="one_record"),
]


@pytest.mark.parametrize("kw,shape,dtype", WRITE_CASES)
def test_cnfrec_files_are_byte_equal_and_read_across(tmp_path, rng, kw, shape, dtype):
    arr = rng.normal(size=shape).astype(dtype)
    mine, theirs = str(tmp_path / "mine.cnfrec"), str(tmp_path / "theirs.cnfrec")
    records.write_records(mine, arr, **kw)
    jrecords.write_records(theirs, arr, **kw)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for path in (mine, theirs):
        assert records.read_header(path) == jrecords.read_header(path)
        for mmap in (True, False):
            np.testing.assert_array_equal(records.read_records(path, mmap=mmap, verify=True), arr)
            np.testing.assert_array_equal(jrecords.read_records(path, mmap=mmap, verify=True),
                                          arr)


def test_cnfrec_verify_and_magic(tmp_path, rng):
    path = str(tmp_path / "c.cnfrec")
    records.write_records(path, rng.normal(size=(10, 4)).astype(np.float32))
    with open(path, "r+b") as f:
        f.seek(-1, 2)
        b = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([b[0] ^ 0xFF]))
    records.read_records(path)  # no check asked for
    with pytest.raises(IOError, match="CRC"):
        records.read_records(path, verify=True)
    with pytest.raises(IOError, match="CRC"):
        records.verify_records([path])
    bad = str(tmp_path / "bad.cnfrec")
    with open(bad, "wb") as f:
        f.write(b"NOTAREC0" + bytes(64))
    with pytest.raises(IOError, match="CNFREC01"):
        records.read_header(bad)


def test_write_class_sorted_dataset_equals_jax(tmp_path):
    imgs, labels = synthetic_digits(num_per_class=6, num_classes=3, size=8)
    for combined in (False, True):
        a = records.write_class_sorted_dataset(str(tmp_path / "mine"), "train", imgs[..., 0],
                                               labels, [0, 2], combined)
        b = jrecords.write_class_sorted_dataset(str(tmp_path / "theirs"), "train", imgs[..., 0],
                                                labels, [0, 2], combined)
        assert [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b]
        for p, q in zip(a, b):
            with open(p, "rb") as f, open(q, "rb") as g:
                assert f.read() == g.read(), p
        assert list(records.verify_records(a).values()) == list(
            jrecords.verify_records(b).values())


def test_tfrecords_are_byte_equal_and_read_across(tmp_path, rng):
    imgs = rng.random((6, 5, 5, 2), np.float32)
    lab = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 6)]
    mine, theirs = str(tmp_path / "mine.tfrecords"), str(tmp_path / "theirs.tfrecords")
    assert tfc.write_reference_tfrecords(mine, imgs, lab) == 6
    jtfc.write_reference_tfrecords(theirs, imgs, lab)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for read in (tfc.read_reference_tfrecords, jtfc.read_reference_tfrecords):
        got_imgs, got_lab = read(mine, verify=True)
        np.testing.assert_array_equal(got_imgs, imgs)
        np.testing.assert_array_equal(got_lab, lab)
    assert tfc.parse_example(tfc.encode_example({"height": tfc._int64_feature(300)})) == {
        "height": [300]}


def test_convert_to_cnfrec_across_the_packages(tmp_path, rng):
    """A one-class reference file converts to the same .cnfrec in both
    packages, carrying its label; a corrupted frame fails the check."""
    imgs = rng.random((7, 6, 6, 1), np.float32)
    onehot = np.zeros((7, 4), np.float32)
    onehot[:, 2] = 1.0
    path = str(tmp_path / "x_train_test_c2.tfrecords")
    jtfc.write_reference_tfrecords(path, imgs, onehot)
    mine, theirs = str(tmp_path / "mine.cnfrec"), str(tmp_path / "theirs.cnfrec")
    assert tuple(tfc.convert_to_cnfrec(path, mine)) == imgs.shape
    jtfc.convert_to_cnfrec(path, theirs)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert records.read_header(mine)["label"] == 2
    np.testing.assert_array_equal(records.read_records(mine, verify=True), imgs)
    with open(path, "r+b") as f:
        f.seek(40)
        b = f.read(1)
        f.seek(40)
        f.write(bytes([b[0] ^ 0x01]))
    with pytest.raises(IOError, match="CRC"):
        tfc.read_reference_tfrecords(path, verify=True)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 4099])
def test_crc32c_equals_jax(rng, n):
    data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
    want = jtfc.crc32c(data)
    assert tfc.crc32c(data) == tfc.crc32c_plain(data) == want
    assert tfc.masked_crc32c(data) == jtfc.masked_crc32c(data)


def test_crc32c_known_vector():
    assert tfc.crc32c(b"123456789") == tfc.crc32c_plain(b"123456789") == 0xE3069283
    assert jtfc.crc32c(b"123456789") == 0xE3069283


# ---------------------------------------------------------------------------
# the native loader: the cases of tests/test_native_loader.py
# ---------------------------------------------------------------------------


def test_native_loader_builds_with_gxx():
    """g++ is in the image, so the library must build, into the port's
    _build/ (never into native/), keyed by the source and the flags."""
    lib = native_loader.load_library()
    path = build.host_library_path(native_loader.SOURCE)
    assert path.parent == build.BUILD_DIR and path.is_file()
    assert path.name.startswith("libcnfrec_loader-") and path.name in native_loader.reader_name()
    assert lib.cnf_crc32c(b"a", 1) == tfc.crc32c_plain(b"a")


def test_a_failed_loader_build_raises_with_the_compilers_stderr(tmp_path, monkeypatch):
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'error: stand-in compiler refused' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "gxx_path", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="stand-in compiler refused"):
        native_loader.NativeRecordFile(str(tmp_path / "any.cnfrec"))
    assert list((tmp_path / "_build").iterdir()) == []


def test_header_and_count(record_file):
    path, arr = record_file
    f = native_loader.NativeRecordFile(path, verify=True)
    assert f.count == 100
    assert f.record_shape == (6, 6, 2)
    assert f.dtype == np.float32
    assert f.header["label"] == 1
    f.close()


def test_gather_matches_python(record_file, rng, monkeypatch):
    path, arr = record_file
    f = native_loader.NativeRecordFile(path)
    idx = rng.integers(0, 100, size=37)
    np.testing.assert_array_equal(f.gather(idx), records.read_records(path)[idx])
    big = rng.integers(0, 100, size=600)  # past the loader's 256-row threaded cut-off
    out = np.empty((600, 6, 6, 2), np.float32)
    monkeypatch.setattr(native_loader, "GATHER_THREADS", 3)  # threaded on any host
    assert f.gather(big, out=out) is out
    np.testing.assert_array_equal(out, arr[big])
    with pytest.raises(ValueError, match="contiguous"):
        f.gather(big, out=np.empty((600, 6, 6, 3), np.float32))
    f.close()


def test_gather_multi(tmp_path, rng):
    arrs, files = [], []
    for c in range(3):
        a = rng.normal(size=(20, 4, 4, 1)).astype(np.float32)
        p = str(tmp_path / f"c{c}.cnfrec")
        records.write_records(p, a, label=c)
        arrs.append(a)
        files.append(native_loader.NativeRecordFile(p))
    fid = rng.integers(0, 3, size=300).astype(np.int32)
    idx = rng.integers(0, 20, size=300)
    got = native_loader.gather_multi(files, fid, idx)
    np.testing.assert_array_equal(got, np.stack([arrs[f][i] for f, i in zip(fid, idx)]))
    for f in files:
        f.close()


def test_crc_detects_corruption(tmp_path, rng):
    arr = rng.normal(size=(10, 4)).astype(np.float32)
    path = str(tmp_path / "c.cnfrec")
    records.write_records(path, arr)
    with open(path, "r+b") as f:
        f.seek(-1, 2)
        b = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IOError):
        native_loader.NativeRecordFile(path, verify=True)


def test_prefetching_epoch_loader(record_file, rng):
    path, arr = record_file
    f = native_loader.NativeRecordFile(path)
    order = rng.permutation(100)
    batches = list(native_loader.PrefetchingEpochLoader(f, 10).epoch(order))
    assert len(batches) == 10
    np.testing.assert_array_equal(np.concatenate(batches), arr[order])
    f.close()


def test_gather_after_close_raises(record_file):
    path, _ = record_file
    f = native_loader.NativeRecordFile(path)
    f.close()
    with pytest.raises(ValueError, match="closed"):
        f.gather(np.arange(4))
    with pytest.raises(ValueError, match="closed"):
        native_loader.gather_multi([f], np.zeros(2, np.int32), np.arange(2))


def test_prefetch_loader_abandoned_generator_reaps_worker(record_file, rng):
    """Breaking out of an epoch mid-way must not leave the worker thread
    blocked on the bounded queue."""
    path, _ = record_file
    f = native_loader.NativeRecordFile(path)
    before = threading.active_count()
    gen = native_loader.PrefetchingEpochLoader(f, 10).epoch(rng.permutation(100))
    next(gen)
    gen.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    f.close()


def test_prefetch_worker_errors_reach_the_consumer():
    def assemble(i):
        if i == 3:
            raise KeyError("row 3")
        return i

    got = []
    with pytest.raises(KeyError, match="row 3"):
        for item in native_loader._prefetched(range(10), assemble):
            got.append(item)
    assert got == [0, 1, 2]


def test_native_crc32c_known_vector_and_python_agreement(rng):
    assert native_loader.crc32c_native(b"123456789") == 0xE3069283
    data = rng.normal(size=1000).astype(np.float32).tobytes()
    assert native_loader.crc32c_native(data) == tfc.crc32c_plain(data) == jtfc.crc32c(data)


def test_truncated_file_rejected(tmp_path, rng):
    """A file truncated in the header or the blob fails cnf_open cleanly
    (IOError), not with a SIGBUS later."""
    arr = rng.normal(size=(20, 4, 4, 2)).astype(np.float32)
    path = str(tmp_path / "t.cnfrec")
    records.write_records(path, arr)
    with open(path, "rb") as f:
        full = f.read()
    for cut in (12, 20, len(full) - 100):
        p2 = str(tmp_path / f"cut{cut}.cnfrec")
        with open(p2, "wb") as f:
            f.write(full[:cut])
        with pytest.raises(IOError):
            native_loader.NativeRecordFile(p2)
    with pytest.raises(IOError):
        native_loader.NativeRecordFile(str(tmp_path / "missing.cnfrec"))


def test_extra_crc32_key_does_not_shadow_checksum(tmp_path, rng):
    arr = rng.normal(size=(10, 3, 3, 1)).astype(np.float32)
    path = str(tmp_path / "x.cnfrec")
    records.write_records(path, arr, extra={"crc32": 1, "count": 999})
    f = native_loader.NativeRecordFile(path, verify=True)
    assert f.count == 10
    np.testing.assert_array_equal(f.gather(np.arange(10)), arr)
    f.close()


def test_out_of_range_indices_raise(record_file):
    path, _ = record_file
    f = native_loader.NativeRecordFile(path)
    with pytest.raises(IndexError):
        f.gather(np.array([0, 100]))
    with pytest.raises(IndexError):
        f.gather(np.array([-1]))
    with pytest.raises(IndexError):
        native_loader.gather_multi([f], np.zeros(1, np.int32), np.array([100]))
    with pytest.raises(IndexError):
        native_loader.gather_multi([f], np.ones(1, np.int32), np.array([0]))
    f.close()


def test_gather_multi_mixed_shapes_rejected(tmp_path, rng):
    a = rng.normal(size=(4, 2, 2, 1)).astype(np.float32)
    b = rng.normal(size=(4, 3, 3, 1)).astype(np.float32)
    pa, pb = str(tmp_path / "a.cnfrec"), str(tmp_path / "b.cnfrec")
    records.write_records(pa, a)
    records.write_records(pb, b)
    fa, fb = native_loader.NativeRecordFile(pa), native_loader.NativeRecordFile(pb)
    with pytest.raises(ValueError, match="identical record shapes"):
        native_loader.gather_multi([fa, fb], np.array([1], np.int32), np.array([0]))
    fa.close()
    fb.close()


def test_logitify_np_matches_jax_and_torch():
    x = np.random.default_rng(0).uniform(0, 1, size=(4, 5, 5, 1)).astype(np.float32)
    np.testing.assert_array_equal(logit.logitify_np(x), jlogit.logitify_np(x))
    np.testing.assert_allclose(logit.logitify_np(x), logit.logitify(torch.from_numpy(x)).numpy(),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# streaming sources against the in-RAM ones, for one generator
# ---------------------------------------------------------------------------


def class_records(tmp_path, per_class=20, size=8, classes=(0, 1)):
    imgs, labels = synthetic_digits(num_per_class=per_class, num_classes=3, size=size)
    records.write_class_sorted_dataset(str(tmp_path), "train", imgs, labels, classes,
                                       combined=False)
    paths = [records.class_file(str(tmp_path), "train", c) for c in classes]
    return imgs, labels, paths


def assert_same_batches(ram, stream, seed, epochs=1):
    """Both sources' epochs from clones of one generator: the same batches,
    bit for bit, and the generators left in the same state."""
    g_ram = torch.Generator().manual_seed(seed)
    g_stream = torch.Generator().manual_seed(seed)
    for _ in range(epochs):
        a, b = list(ram.epoch(g_ram)), list(stream.epoch(g_stream))
        assert len(a) == len(b) == ram.num_batches
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == torch.float32 and x.shape == y.shape
            assert torch.equal(x, y)
    assert torch.equal(g_ram.get_state(), g_stream.get_state())


@pytest.mark.parametrize("use_logits,alpha", [(True, 0.98), (False, 0.98), (True, 1.0)])
def test_streaming_class_source_matches_in_ram(tmp_path, use_logits, alpha):
    imgs, labels, paths = class_records(tmp_path, classes=(0, 2))
    ram = ClassConditionalSource(imgs, labels, [0, 2], 8, use_logits=use_logits,
                                 noise_floor_alpha=alpha)
    stream = native_loader.StreamingClassSource(paths, [0, 2], 8, use_logits=use_logits,
                                                noise_floor_alpha=alpha)
    assert stream.num_batches == ram.num_batches == 4
    assert stream.xy_shape == ram.xy_shape == (8, 8, 2)
    assert_same_batches(ram, stream, seed=5)
    stream.close()


def test_streaming_class_source_matches_over_epochs_without_a_distributed_epoch(tmp_path):
    """Two epochs from one generator, three classes of unequal counts; the
    multi-device epoch is not ported (ROADMAP A.10), so the streaming source
    has none, as the in-RAM one has none."""
    imgs, labels = synthetic_digits(num_per_class=27, num_classes=3, size=8)
    keep = np.ones(len(labels), bool)
    keep[np.flatnonzero(labels == 1)[:9]] = False
    imgs, labels = imgs[keep], labels[keep]
    records.write_class_sorted_dataset(str(tmp_path), "train", imgs, labels, [0, 1, 2], False)
    paths = [records.class_file(str(tmp_path), "train", c) for c in (0, 1, 2)]
    ram = ClassConditionalSource(imgs, labels, [0, 1, 2], 8, use_logits=True)
    stream = native_loader.StreamingClassSource(paths, [0, 1, 2], 8, use_logits=True)
    assert stream.num_batches == ram.num_batches == 3 + 2 + 3
    assert_same_batches(ram, stream, seed=9, epochs=2)
    assert not hasattr(stream, "epoch_distributed") and not hasattr(ram, "epoch_distributed")
    with pytest.raises(ValueError, match="ZERO"):
        native_loader.StreamingClassSource(paths, [0, 1, 2], 32)
    stream.close()


@pytest.mark.parametrize("model_type,residual,alpha", [("SR2,1", True, 0.98),
                                                       ("SR4,2", True, 0.98),
                                                       ("SR2,1", False, 1.0)])
def test_streaming_sr_source_matches_in_ram(tmp_path, model_type, residual, alpha):
    imgs, _ = synthetic_digits(num_per_class=10, num_classes=2, size=8)
    records.write_class_sorted_dataset(str(tmp_path), "train", imgs,
                                       np.zeros(len(imgs), np.int32), [0], combined=True)
    path = records.combined_file(str(tmp_path), "train")
    ram = SRSource(imgs, model_type, 8, residual=residual, noise_floor_alpha=alpha)
    stream = native_loader.StreamingSRSource(path, model_type, 8, residual=residual,
                                             noise_floor_alpha=alpha)
    assert stream.num_batches == ram.num_batches == 2
    assert stream.xy_shape == ram.xy_shape == ((4, 4, 2) if model_type == "SR4,2" else (8, 8, 2))
    assert_same_batches(ram, stream, seed=2, epochs=2)
    stream.close()


# ---------------------------------------------------------------------------
# cnf-build-records, cnf-conv and cnf-eval with records
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["--combined"], ["--tfrecords"],
                                   ["--combined", "--tfrecords", "--no-verify"]])
def test_cnf_build_records_writes_jax_files(tmp_path, flags):
    """The same files as JAX's cnf-build-records, byte for byte (the
    synthetic digits are the same arrays in both packages)."""
    args = ["--dataset", "synthetic", "--which-classes", "1", "3", *flags]
    mine = build_records.main(args + ["--outdir", str(tmp_path / "mine")])
    theirs = jbuild.main(args + ["--outdir", str(tmp_path / "theirs")])
    assert [os.path.basename(p) for p in mine] == [os.path.basename(p) for p in theirs]
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert sorted(os.listdir(tmp_path / "mine")) == names
    assert any(n.endswith(".tfrecords") for n in names) == ("--tfrecords" in flags)
    for name in names:
        with open(tmp_path / "mine" / name, "rb") as a, open(tmp_path / "theirs" / name, "rb") as b:
            assert a.read() == b.read(), name
    for p in mine:
        if "class" in p:
            assert records.read_header(p)["label"] in (1, 3)


def test_cnf_build_records_refuses_plot_and_no_classes(tmp_path):
    with pytest.raises(SystemExit, match="A.9"):
        build_records.main(["--dataset", "synthetic", "--outdir", str(tmp_path), "--plot"])
    with pytest.raises(SystemExit, match="at least one class"):
        build_records.main(["--dataset", "synthetic", "--outdir", str(tmp_path),
                            "--which-classes"])


#: cnf-conv's tiny arch of tests/test_torch_drivers.py
ARCH = ["--squeeze-factor", "0", "1", "--res-blocks", "1", "1", "--kernels", "8", "8",
        "--cardinality", "2", "2", "--no-dilations"]


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    """cnf-build-records' synthetic set, per-class and combined, classes 0-1
    (256 train and 64 test images a class)."""
    out = str(tmp_path_factory.mktemp("recs"))
    build_records.main(["--dataset", "synthetic", "--which-classes", "0", "1", "--outdir", out])
    build_records.main(["--dataset", "synthetic", "--which-classes", "0", "1", "--combined",
                        "--outdir", out])
    return out


def records_run(recs, out, *flags, epochs=1):
    return conv.main(["--cpu", "--records-dir", recs, "--data-classes", "0", "1",
                      "--batch-size", "32", *ARCH, "--epochs", str(epochs),
                      "--annealing-epochs", "1", "--scan-steps", "2", "--checkpoint-every", "1",
                      "--eval-samples", "4", "--outdir", out, *flags])


def history(outdir):
    with open(os.path.join(outdir, "history.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "seconds"} for line in f]


def params(outdir, epoch):
    return torch.load(os.path.join(outdir, "checkpoints", str(epoch), "state.pt"),
                      weights_only=True)["params"]


def test_cnf_conv_streamed_equals_in_ram(recs, tmp_path, capsys):
    """--stream-records (the native loader) and --no-stream-records (the
    in-RAM sources) train on the same batches: the same histories and
    weights, bit for bit; the log names the reader."""
    streamed, in_ram = str(tmp_path / "streamed"), str(tmp_path / "in_ram")
    records_run(recs, streamed)
    log = capsys.readouterr().out
    assert "records: streamed through the native loader libcnfrec_loader-" in log
    records_run(recs, in_ram, "--no-stream-records")
    assert "records: read into RAM by records.read_records" in capsys.readouterr().out
    rows = history(streamed)
    assert [r["epoch"] for r in rows] == [0, 1] and rows == history(in_ram)
    a, b = params(streamed, 1), params(in_ram, 1)
    assert all(torch.equal(a[k], b[k]) for k in b)
    with open(os.path.join(streamed, "eval.json")) as f, \
            open(os.path.join(in_ram, "eval.json")) as g:
        assert json.load(f)["sampling"] == json.load(g)["sampling"]


def test_a_resumed_records_run_equals_an_uninterrupted_one(recs, tmp_path):
    """2 epochs then a resumed third give the losses and weights of 3 epochs
    in one run: the checkpoint carries the generator, and the streaming
    source draws from it as the in-RAM one does."""
    resumed, whole = str(tmp_path / "resumed"), str(tmp_path / "whole")
    records_run(recs, resumed)
    records_run(recs, resumed, epochs=2)
    records_run(recs, whole, epochs=2)
    rows = history(resumed)
    assert [r["epoch"] for r in rows] == [0, 1, 2] and rows == history(whole)
    a, b = params(resumed, 2), params(whole, 2)
    assert all(torch.equal(a[k], b[k]) for k in b)


def test_cnf_conv_sr_streams_the_combined_file(recs, tmp_path):
    out = str(tmp_path / "sr")
    conv.main(["--cpu", "--model-type", "SR4,2", "--records-dir", recs, "--batch-size", "64",
               "--squeeze-factor", "0", "0", *ARCH[3:], "--epochs", "1",
               "--annealing-epochs", "0", "--checkpoint-every", "0", "--eval-samples", "4",
               "--outdir", out])
    rows = history(out)
    assert len(rows) == 1 and np.isfinite(rows[0]["loss"]) and np.isfinite(rows[0]["val_loss"])


def test_sr_records_without_a_combined_file(recs, tmp_path):
    """SR streaming needs the combined file; --no-stream-records reads the
    per-class files instead, the rows JAX's load_from_records reads."""
    per_class = str(tmp_path / "per_class")
    os.makedirs(per_class)
    for name in os.listdir(recs):
        if "class" in name:
            shutil.copy(os.path.join(recs, name), per_class)
    args = conv.build_parser().parse_args(["--model-type", "SR2,1", "--records-dir", per_class,
                                           "--data-classes", "0", "1"])
    with pytest.raises(FileNotFoundError, match="--combined"):
        conv.make_source(args, "train", stream=True)
    x, y = conv.load_from_records(args, "test")
    jx, jy = jconv.load_from_records(args, "test")
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert x.shape == (128, 28, 28, 1)


@pytest.mark.parametrize("model_type", ["class", "SR2,1"])
def test_records_read_the_rows_jax_reads(recs, model_type):
    args = conv.build_parser().parse_args(["--model-type", model_type, "--records-dir", recs,
                                           "--data-classes", "1", "0"])
    for split in ("train", "test"):
        x, y = conv.load_from_records(args, split)
        jx, jy = jconv.load_from_records(args, split)
        assert x.dtype == jx.dtype == np.float32
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_cnf_eval_reads_the_records(recs, tmp_path, capsys):
    """cnf-eval --records-dir on a records run's checkpoint scores the test
    split of the files: the rows JAX's load_from_records reads, which are
    cnf-build-records' synthetic test digits, so the report equals that of
    --dataset synthetic at the same size."""
    out = str(tmp_path / "run")
    records_run(recs, out, "--epochs", "0")
    capsys.readouterr()
    ck = ["--cpu", "--checkpoint-dir", os.path.join(out, "checkpoints"), "--data-classes", "0",
          "1", "--batch-size", "32", "--eval-samples", "4"]
    report = evaluate.main(ck + ["--records-dir", recs])
    assert "records: read into RAM by records.read_records" in capsys.readouterr().out
    assert report["epoch"] == 0 and np.isfinite(report["bits_per_dim"])
    assert set(report["sampling"]["per_class"]) == {"0", "1"}
    args = evaluate.build_parser().parse_args(ck + ["--records-dir", recs])
    x, y = conv.load_from_records(args, "test")
    jx, jy = jconv.load_from_records(args, "test")
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    synthetic = evaluate.main(ck + ["--dataset", "synthetic", "--synthetic-per-class", "256"])
    assert {k: v for k, v in report.items() if k != "dataset"} == {
        k: v for k, v in synthetic.items() if k != "dataset"}


def test_streaming_source_keeps_host_memory_bounded(recs):
    """The streaming source holds no dataset array: only the files' maps
    (the in-RAM source keeps every row)."""
    src, x_d, y_d = conv.streaming_source(
        conv.build_parser().parse_args(["--records-dir", recs, "--data-classes", "0", "1",
                                        "--batch-size", "32"]), "train")
    assert (x_d, y_d) == (1, 1) and src.num_batches == 16
    assert not any(isinstance(v, np.ndarray) and v.size > 1000 for v in vars(src).values())
    src.close()
