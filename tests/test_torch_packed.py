"""The port's spec packs, packed and device-resident loaders and process
slicing against the JAX package, on the CPU.

The native reader (``csrc/specpack.cc``) is built here with the host C++
compiler through ``ops/_build.py``'s hash cache; the JAX side reads with
its numpy reader.  ``DeviceResidentPairs`` runs with ``device="cpu"``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from music_style_transfer_ldm_tpu.datasets import BatchLoader as JaxLoader
from music_style_transfer_ldm_tpu.datasets import (
    DeviceResidentPairs as JaxDevicePairs,
)
from music_style_transfer_ldm_tpu.datasets import (
    PackedBatchLoader as JaxPackedLoader,
)
from music_style_transfer_ldm_tpu.datasets import (
    PackedPairDataset as JaxPackedPairs,
)
from music_style_transfer_ldm_tpu.datasets import (
    PackedSpectrogramDataset as JaxPacked,
)
from music_style_transfer_ldm_tpu.datasets import (
    process_local_indices as jax_process_local_indices,
)
from music_style_transfer_ldm_tpu.datasets.packed import (
    write_pack as jax_write_pack,
)
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.datasets import (
    BatchLoader, DevicePairLoader, DeviceResidentPairs, PackedBatchLoader,
    PackedPairDataset, PackedSpectrogramDataset, SpectrogramDataset,
    SpectrogramPairDataset, build_pack, generate_pairings,
    process_local_indices,
)
from music_style_transfer_ldm_tpu_torch.datasets import packed as pk
from music_style_transfer_ldm_tpu_torch.training.train_autoencoder import (
    AETrainer,
)
from music_style_transfer_ldm_tpu_torch.training.train_ldm import LDMTrainer
from music_style_transfer_ldm_tpu_torch.utils.png import write_png_gray

CLASSES = ["guitar", "piano", "violin"]


@pytest.fixture(scope="module")
def native():
    """The native reader's library (built once through the hash cache)."""
    assert pk._load_native() is not None, "csrc/specpack.cc did not build"
    return pk._load_native()


@pytest.fixture
def pack(tmp_path):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (20, 128, 130), np.uint8)
    labels = (np.arange(20) % 3).astype(np.uint16)
    path = tmp_path / "d.spk"
    pk.write_pack(path, images, labels, CLASSES)
    return path, images, labels


def _png_tree(root, counts=(("a", 5), ("b", 4), ("c", 3)), size=(128, 130)):
    rng = np.random.RandomState(1)
    for label, n in counts:
        (root / label).mkdir(parents=True)
        for i in range(n):
            img = rng.randint(0, 256, size).astype(np.uint8)
            (root / label / f"{i:03d}.png").write_bytes(write_png_gray(img))
    return root


@pytest.fixture
def tree(tmp_path):
    """A PNG tree, its pack and a pairings CSV over it."""
    root = _png_tree(tmp_path / "imgs")
    generate_pairings(root, tmp_path / "pairs.csv", num_pairs=30)
    assert build_pack(root, tmp_path / "d.spk") == 12
    return root, tmp_path / "d.spk", tmp_path / "pairs.csv"


# ---------------- the container ---------------------------------------------


def test_write_pack_is_byte_identical_and_cross_readable(pack, tmp_path,
                                                         native):
    path, images, labels = pack
    jax_write_pack(tmp_path / "jax.spk", images, labels, CLASSES)
    assert path.read_bytes() == (tmp_path / "jax.spk").read_bytes()
    idx = np.asarray([0, 7, 19, 7])
    want, want_y = JaxPacked(path, use_native=False).gather(idx)
    for use_native in (True, False):
        got, got_y = PackedSpectrogramDataset(
            tmp_path / "jax.spk", use_native=use_native).gather(idx)
        np.testing.assert_array_equal(got, want)        # f32: same bits
        np.testing.assert_array_equal(got_y, want_y)


def test_build_pack_reads_pngs_in_folder_order(tree):
    root, spk, _ = tree
    ds = PackedSpectrogramDataset(spk, use_native=False)
    folder = SpectrogramDataset(root)
    assert ds.classes == folder.classes == ["a", "b", "c"]
    x, y = ds.gather(np.arange(len(ds)))
    for i in range(len(ds)):
        want, label = folder[i]
        np.testing.assert_array_equal(x[i], want)
        assert y[i] == label


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_native_and_numpy_readers_agree_bit_for_bit(pack, native, dtype):
    path, images, _ = pack
    nat = PackedSpectrogramDataset(path)
    ref = PackedSpectrogramDataset(path, use_native=False)
    assert nat.native and not ref.native
    assert nat.classes == ref.classes == CLASSES
    idx = np.random.RandomState(2).randint(0, 20, 300)
    xn, yn = nat.gather(idx, dtype=dtype)
    xr, yr = ref.gather(idx, dtype=dtype)
    assert xn.dtype == np.dtype(dtype) and xn.shape == (300, 128, 128, 1)
    np.testing.assert_array_equal(xn, xr)
    np.testing.assert_array_equal(yn, yr)
    np.testing.assert_array_equal(nat.labels(), ref.labels())
    if dtype == "uint8":
        np.testing.assert_array_equal(xn[:, :, :, 0],
                                      images[idx, :128, :128])
    nat.close()


@pytest.mark.parametrize("use_native", [True, False])
def test_bad_magic_and_bad_indices_are_refused(pack, tmp_path, native,
                                               use_native):
    (tmp_path / "junk.spk").write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="specpack"):
        PackedSpectrogramDataset(tmp_path / "junk.spk", use_native=use_native)
    path, _, _ = pack
    ds = PackedSpectrogramDataset(path, use_native=use_native)
    assert ds.native == use_native
    for bad in ([0, 20], [-1]):
        for dtype in ("uint8", "float32"):
            with pytest.raises(IndexError):
                ds.gather(np.asarray(bad), dtype=dtype)
    big = PackedSpectrogramDataset(path, crop=131, use_native=use_native)
    with pytest.raises(ValueError, match="crop"):
        big.gather(np.asarray([0]))


def test_pack_cli_builds_and_packs(tree, tmp_path, capsys, native):
    root, spk, _ = tree
    assert pk.main(["--build", "--pack", str(root),
                    str(tmp_path / "cli.spk")]) == 0
    assert "packed 12 items" in capsys.readouterr().out
    assert (tmp_path / "cli.spk").read_bytes() == spk.read_bytes()


# ---------------- pairs and loaders ------------------------------------------


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_packed_pairs_match_jax(tree, native, dtype):
    root, spk, pairs = tree
    port = PackedPairDataset(spk, pairs)
    ref = JaxPackedPairs(spk, pairs, use_native=False)
    assert port.pack.native and port.pairs == ref.pairs
    idx = [0, 3, 29, 3]
    for got, want in zip(port.gather_pairs(idx, dtype=dtype),
                         ref.gather_pairs(idx, dtype=dtype)):
        np.testing.assert_array_equal(got, want)
    (a, la), (b, lb) = port[5]
    (ja, jla), (jb, jlb) = ref[5]
    assert (la, lb) == (jla, jlb)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    # the folder dataset over the PNG tree gives the same pairs
    (fa, _), (fb, _) = SpectrogramPairDataset(root, pairs)[5]
    np.testing.assert_array_equal(a, fa)
    np.testing.assert_array_equal(b, fb)


def _flat(batch):
    """A loader batch as a list of numpy arrays and label lists."""
    if isinstance(batch, tuple):
        return [x for part in batch for x in _flat(part)]
    if isinstance(batch, torch.Tensor):
        return [batch.cpu().numpy()]
    return [np.asarray(batch)]


@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_packed_batch_loader_matches_jax(tree, native, pair, dtype):
    _, spk, pairs = tree
    if pair:
        port_ds, ref_ds = (PackedPairDataset(spk, pairs),
                           JaxPackedPairs(spk, pairs, use_native=False))
    else:
        port_ds, ref_ds = (PackedSpectrogramDataset(spk),
                           JaxPacked(spk, use_native=False))
    got_loader = PackedBatchLoader(port_ds, 8, seed=3, dtype=dtype)
    want_loader = JaxPackedLoader(ref_ds, 8, seed=3, dtype=dtype)
    for _ in range(2):     # two epochs: the order reshuffles alike
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == len(got_loader)
        for g, w in zip(got, want):
            for a, b in zip(_flat(g), _flat(w)):
                np.testing.assert_array_equal(a, b)


class _ArrayDS:
    """Items i -> [i] (tests/test_multihost.py's dataset)."""

    def __init__(self, n):
        self.data = np.arange(n, dtype=np.float32).reshape(n, 1)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]

    def gather(self, idx, dtype="float32"):
        return self.data[np.asarray(idx)], np.asarray(idx, np.int32)


def test_process_local_indices_partition_like_jax():
    g = np.arange(100, 113)              # 13 rows, P=4: 4 each, 3 pads
    slices = [process_local_indices(g, p, 4) for p in range(4)]
    for p in range(4):
        np.testing.assert_array_equal(slices[p],
                                      jax_process_local_indices(g, p, 4))
    assert all(len(s) == 4 for s in slices)
    merged = np.concatenate(slices)
    np.testing.assert_array_equal(merged[:13], g)
    np.testing.assert_array_equal(merged[13:], [112, 112, 112])
    np.testing.assert_array_equal(
        np.concatenate([process_local_indices(np.arange(8), p, 2)
                        for p in range(2)]), np.arange(8))
    with pytest.raises(ValueError):
        process_local_indices(np.arange(4), 2, 2)


@pytest.mark.parametrize("packed", [False, True])
def test_loader_process_slices_reassemble_global(packed):
    ds = _ArrayDS(40)

    def mk(pi, pc):
        if packed:
            return PackedBatchLoader(ds, 16, seed=3, pair=False,
                                     process_index=pi, process_count=pc)
        return BatchLoader(ds, 16, seed=3, num_threads=1, process_index=pi,
                           process_count=pc)

    def rows(batch):
        return batch[0] if packed else batch

    whole, p0, p1 = list(mk(0, 1)), list(mk(0, 2)), list(mk(1, 2))
    assert len(whole) == len(p0) == len(p1) == 3
    for g, a, b in zip(whole, p0, p1):
        np.testing.assert_array_equal(np.concatenate([rows(a), rows(b)]),
                                      rows(g))
    tail = [list(BatchLoader(_ArrayDS(10), 8, shuffle=False, num_threads=1,
                             process_index=p, process_count=4))[1]
            for p in range(4)]
    np.testing.assert_array_equal(np.concatenate(tail).ravel(),
                                  [8, 9, 9, 9])     # pad = the last row
    jax_tail = [list(JaxLoader(_ArrayDS(10), 8, shuffle=False, num_threads=1,
                               process_index=p, process_count=4))[1]
                for p in range(4)]
    np.testing.assert_array_equal(np.concatenate(tail),
                                  np.concatenate(jax_tail))


def test_packed_gather_process_slice(pack, native):
    path, _, _ = pack
    ds = PackedSpectrogramDataset(path)
    idx = np.arange(3, 16)
    for p in range(3):
        x, y = ds.gather(idx, process_index=p, process_count=3)
        want, want_y = ds.gather(process_local_indices(idx, p, 3))
        np.testing.assert_array_equal(x, want)
        np.testing.assert_array_equal(y, want_y)


# ---------------- device-resident pairs ---------------------------------------


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_device_resident_pairs_match_jax(tree, dtype):
    _, spk, pairs = tree
    port = DeviceResidentPairs(spk, pairs, device="cpu")
    ref = JaxDevicePairs(spk, pairs)
    assert tuple(port.images.shape) == (12, 128, 128, 1)
    assert port.images.dtype == torch.uint8
    assert port.nbytes == 12 * 128 * 128
    idx = [2, 0, 29, 17, 2]
    for got, want in zip(port.gather_pairs(idx, dtype=dtype),
                         ref.gather_pairs(idx, dtype=dtype)):
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_three_loaders_yield_the_same_batches(tree, native):
    """BatchLoader over the PNG tree, PackedBatchLoader(uint8) over the
    pack and DevicePairLoader: the same batches, in the same order, after
    as_unit_images (k/255 from the same bytes on every route)."""
    from music_style_transfer_ldm_tpu_torch.training.state import (
        as_unit_images,
    )
    root, spk, pairs = tree
    loaders = [
        BatchLoader(SpectrogramPairDataset(root, pairs), 8, seed=5),
        PackedBatchLoader(PackedPairDataset(spk, pairs), 8, seed=5,
                          dtype="uint8"),
        DevicePairLoader(DeviceResidentPairs(spk, pairs, device="cpu"), 8,
                         seed=5)]
    for batches in zip(*loaders):
        ref = None
        for (c, lc), (s, ls) in batches:
            got = [as_unit_images(torch.as_tensor(np.asarray(c))),
                   as_unit_images(torch.as_tensor(np.asarray(s))),
                   list(lc), list(ls)]
            if ref is None:
                ref = got
                continue
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            assert got[2:] == ref[2:]


# ---------------- the trainers on these loaders ---------------------------------


def _tiny(cfg):
    cfg.train = dataclasses.replace(cfg.train, batch_size=4, num_epochs=1,
                                    compute_dtype="float32")
    cfg.model = dataclasses.replace(cfg.model, image_size=64)
    return cfg


def test_ldm_step_fed_by_the_device_corpus_equals_the_png_loader(tmp_path):
    root = _png_tree(tmp_path / "imgs", counts=(("a", 3), ("b", 3)),
                     size=(64, 70))
    generate_pairings(root, tmp_path / "pairs.csv", num_pairs=4)
    build_pack(root, tmp_path / "d.spk")
    cfg = _tiny(default_config())
    loaders = {
        "png": BatchLoader(SpectrogramPairDataset(root, tmp_path /
                                                  "pairs.csv", 64), 4,
                           seed=0),
        "device": DevicePairLoader(DeviceResidentPairs(
            tmp_path / "d.spk", tmp_path / "pairs.csv", crop=64,
            device="cpu"), 4, seed=0)}
    params, metrics = {}, {}
    for name, loader in loaders.items():
        trainer = LDMTrainer(cfg, perceptual=False, device="cpu")
        state, metrics[name] = trainer.train_epoch(trainer.init_state(0),
                                                   loader)
        assert state.step == 1
        params[name] = state.model.state_dict()
    assert metrics["png"] == metrics["device"]
    for k, v in params["png"].items():
        assert torch.equal(v, params["device"][k]), k


def test_ae_trainer_takes_uint8_batches(tmp_path):
    rng = np.random.RandomState(4)
    images = rng.randint(0, 256, (8, 64, 70), np.uint8)
    pk.write_pack(tmp_path / "d.spk", images, np.zeros(8, np.uint16), ["a"])
    cfg = _tiny(default_config())
    states = {}
    for dtype in ("uint8", "float32"):
        ds = PackedSpectrogramDataset(tmp_path / "d.spk", crop=64)
        batch = next(iter(PackedBatchLoader(ds, 4, shuffle=False,
                                            dtype=dtype)))
        assert batch[0].dtype == np.dtype(dtype)
        trainer = AETrainer(cfg, perceptual=False, device="cpu")
        train = PackedBatchLoader(ds, 4, indices=np.arange(4), seed=1,
                                  dtype=dtype)
        val = PackedBatchLoader(ds, 4, indices=np.arange(4, 8),
                                shuffle=False, dtype=dtype)
        states[dtype] = trainer.train(train, val, num_epochs=1,
                                      out_dir=tmp_path / dtype)
    for k, v in states["uint8"].model.state_dict().items():
        assert torch.equal(v, states["float32"].model.state_dict()[k]), k
