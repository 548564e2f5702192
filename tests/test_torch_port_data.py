"""The port's slice data (datasets, the native gather, the device loader,
preprocessing) against the JAX package's, on the CPU.

Everything here is host code, so the comparisons are bit for bit: the
batches of ``SliceDataset.gather_batch`` (native and numpy), the
loader's batches over two shuffled epochs and a ``pad_last`` split, and
the .npy stacks that preprocessing writes from synthetic NIfTI patients.
The loader's thread must end with an abandoned iterator, and an error in
it must reach the consumer.
"""

import threading

import numpy as np
import pytest
import torch

from mudiff_tpu.data import DeviceLoader as JaxLoader
from mudiff_tpu.data import SliceDataset as JaxDataset
from mudiff_tpu.data import preprocess as jpre
from mudiff_tpu.utils import nifti as jnifti
from mudiff_torch.data import ISLES_ORDERS, DeviceLoader, SliceDataset, _native, preprocess

MODS = ("T1", "T2", "FLAIR", "T1CE")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """z-scored stacks with values beyond +-3 (the clamp shows)."""
    root = tmp_path_factory.mktemp("npy")
    rng = np.random.RandomState(0)
    for split, n in (("train", 11), ("val", 7)):
        (root / split).mkdir()
        for mod in MODS + ("DWI",):
            np.save(root / split / f"{mod}.npy", (2.0 * rng.randn(n, 12, 10)).astype(np.float32))
    return str(root)


def _threads():
    return [t for t in threading.enumerate() if t.name == "DeviceLoader" and t.is_alive()]


def _np(batch):
    return [np.asarray(x) for x in batch]


@pytest.mark.parametrize("target", ["T1CE", "FLAIR", "T2", "T1"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_gather_batch_matches_jax_bit_for_bit(data_root, target, native):
    ours = SliceDataset("train", data_root, target, native=native)
    ref = JaxDataset("train", data_root, target)
    idx = np.array([0, 3, 3, 10, 7])
    got, want = ours.gather_batch(idx), ref.gather_batch(idx)
    for g, w in zip(got, want):
        assert g.shape == (5, 12, 10, 1) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert np.abs(got[0]).max() == 1.0  # clamped at +-3 sigma
    c, t = ours[4]
    wc, wt = ref[4]
    np.testing.assert_array_equal(c, wc)
    np.testing.assert_array_equal(t, wt)


def test_native_gather_is_built_by_the_port(data_root):
    """The port builds its own library under mudiff_torch/_build (g++ is
    here), never the JAX side's, and it writes into given buffers."""
    assert _native.native_available(), _native.build_error
    assert _native.library_path().parent == _native.BUILD_DIR
    assert str(_native._LIB._name) == str(_native.library_path())
    ds = SliceDataset("train", data_root, "T1CE")
    out = [np.full((2, 12, 10, 1), 7.0, np.float32) for _ in range(4)]
    got = ds.gather_batch(np.array([1, 2]), out=out)
    assert all(g is o for g, o in zip(got, out))
    for g, w in zip(out, SliceDataset("train", data_root, "T1CE", native=False)
                    .gather_batch(np.array([1, 2]))):
        np.testing.assert_array_equal(g, w)


def test_native_gather_refuses_indices_out_of_range(data_root):
    ds = SliceDataset("train", data_root, "T1CE")
    for bad in ([0, 11], [-1, 2]):
        with pytest.raises(IndexError, match="out of range"):
            ds.gather_batch(np.array(bad))


def test_mmap_and_isles_orders(data_root):
    a = SliceDataset("val", data_root, "FLAIR", orders=ISLES_ORDERS, use_mmap=True)
    b = JaxDataset("val", data_root, "FLAIR", orders=ISLES_ORDERS, use_mmap=True)
    assert a.modality_order == ["T1", "T2", "DWI", "FLAIR"] and len(a) == 7
    for g, w in zip(a.gather_batch(np.arange(7)), b.gather_batch(np.arange(7))):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="Invalid target_modality"):
        SliceDataset("val", data_root, "PD")


@pytest.mark.parametrize("split,batch,shuffle,pad_last", [
    ("train", 3, True, False), ("train", 4, True, True), ("val", 3, False, True),
    ("val", 2, False, False)])
def test_loader_batches_match_jax_over_two_epochs(data_root, split, batch, shuffle, pad_last):
    ours = DeviceLoader(SliceDataset(split, data_root, "T1CE"), batch, shuffle=shuffle, seed=5,
                        pad_last=pad_last, device="cpu", prefetch=1)
    ref = JaxLoader(JaxDataset(split, data_root, "T1CE"), batch, shuffle=shuffle, seed=5,
                    pad_last=pad_last, process_index=0, process_count=1)
    assert len(ours) == len(ref)
    for epoch in (0, 1):
        got = [_np(b) for b in ours.epoch(epoch)]
        want = [_np(b) for b in ref.epoch(epoch)]
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.shape == b.shape and a.dtype == np.float32
                np.testing.assert_array_equal(a, b)
    if shuffle:
        first = [list(s) for s in ours.batch_indices(0)]
        assert first != [list(s) for s in ours.batch_indices(1)]
    assert not _threads()


def test_loader_defaults_to_the_card(data_root):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceLoader(SliceDataset("val", data_root, "T1CE"), 2)


def test_abandoned_iterator_stops_its_thread(data_root):
    loader = DeviceLoader(SliceDataset("train", data_root, "T1CE"), 1, device="cpu",
                          prefetch=1)
    it = loader.epoch(0)
    next(it)
    assert len(_threads()) == 1  # the producer is blocked on a full queue
    it.close()
    assert not _threads()
    it = loader.epoch(1)
    next(it)
    del it  # garbage-collected: the same
    assert not _threads()


def test_producer_error_reaches_the_consumer(data_root):
    class Failing(SliceDataset):
        calls = 0

        def gather_batch(self, indices, out=None):
            Failing.calls += 1
            if Failing.calls == 2:
                raise OSError("disk went away")
            return super().gather_batch(indices, out=out)

    loader = DeviceLoader(Failing("train", data_root, "T1CE"), 2, device="cpu")
    got = []
    with pytest.raises(OSError, match="disk went away"):
        for batch in loader.epoch(0):
            got.append(batch)
    assert len(got) == 1 and not _threads()


@pytest.fixture(scope="module")
def raw_patients(tmp_path_factory):
    """Six BraTS-named patients of three modalities and one missing."""
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.RandomState(1)
    for p in range(6):
        d = root / f"BraTS-{p:03d}"
        d.mkdir()
        for kw in ("t1n", "t1c", "t2w") + (("t2f",) if p != 2 else ()):
            vol = np.abs(rng.randn(14, 12, 9 + p % 2)).astype(np.float32) * (1 + p)
            vol[:3] = 0.0  # background
            jnifti.save(vol, np.eye(4), str(d / f"BraTS-{p:03d}-{kw}.nii.gz"))
    return str(root)


def test_preprocess_writes_the_jax_stacks(raw_patients, tmp_path):
    argv = ["--input_dir", raw_patients, "--slice_half_range", "2", "--train_ratio", "0.5",
            "--val_ratio", "0.34", "--seed", "7"]
    preprocess.main(argv + ["--output_dir", str(tmp_path / "ours")])
    jpre.main(argv + ["--output_dir", str(tmp_path / "ref")])
    for split, n in (("train", 15), ("val", 10), ("test", 5)):
        for mod in MODS:
            got = np.load(tmp_path / "ours" / split / f"{mod}.npy")
            want = np.load(tmp_path / "ref" / split / f"{mod}.npy")
            assert got.shape == (n, 14, 12) and got.dtype == np.float32, (split, mod)
            np.testing.assert_array_equal(got, want)
    assert preprocess.split_patients(list("abcdef"), 3, 0.5, 0.34) == jpre.split_patients(
        list("abcdef"), 3, 0.5, 0.34)
