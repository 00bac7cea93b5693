"""The port's decoded-frame cache (``data/cache.py``): the cases of the JAX
package's ``tests/test_cache.py`` against the port's module (parity of
cached and decoded frames, LRU bounds, the disk tier, CLI wiring), plus the
loader's batches with the cache on and off, equal to each other and to the
JAX loader's. Cached frames are the decoded ones: exact equality."""

import numpy as np
import pytest

from thermal_semantic_segmentation_torch.data.cache import (
    DecodeCache, decode_cache, set_decode_cache)


@pytest.fixture()
def freiburg_root(tmp_path):
    from tests.synthetic import make_freiburg_tree
    return make_freiburg_tree(str(tmp_path / "freiburg"), n_train=4)


def test_cache_hits_and_parity(freiburg_root):
    from thermal_semantic_segmentation_torch.cli._common import train_transform
    from thermal_semantic_segmentation_torch.data.freiburg import Freiburg

    ds = Freiburg(freiburg_root, "train", "IR", transforms=train_transform(),
                  with_label=True)
    cold = ds.get(0, np.random.default_rng(5))
    set_decode_cache(64)
    try:
        first = ds.get(0, np.random.default_rng(5))   # fills cache
        assert decode_cache().misses >= 1
        hits_before = decode_cache().hits
        second = ds.get(0, np.random.default_rng(5))  # pure cache hits
        assert decode_cache().hits > hits_before
        np.testing.assert_array_equal(first["image"], cold["image"])
        np.testing.assert_array_equal(second["image"], cold["image"])
        np.testing.assert_array_equal(second["label"], cold["label"])
    finally:
        set_decode_cache(0)


def test_lru_eviction_bounds_bytes():
    cache = DecodeCache(max_bytes=3000)
    for i in range(10):
        cache.get_or_decode(i, lambda i=i: np.full((1000,), i, np.uint8))
    assert cache.nbytes <= 3000
    # most recent entries survive, oldest evicted
    assert 9 in cache._entries and 0 not in cache._entries
    # an over-sized entry is returned but not cached
    big = cache.get_or_decode("big", lambda: np.zeros((5000,), np.uint8))
    assert big.shape == (5000,) and "big" not in cache._entries


def test_disabled_cache_decodes_every_time():
    cache = DecodeCache(max_bytes=0)
    calls = []
    for _ in range(3):
        cache.get_or_decode("k", lambda: calls.append(1) or np.zeros(4))
    assert len(calls) == 3


def test_cli_flag_sets_global_cache():
    from thermal_semantic_segmentation_torch.cli.options import seg_parse
    try:
        seg_parse().parse_args(["--decode_cache_mb", "8"])
        assert decode_cache().max_bytes == 8 * 2**20
    finally:
        set_decode_cache(0)


def test_disk_tier_survives_fresh_cache(tmp_path):
    """A new DecodeCache instance (= a fresh process) must serve from the
    disk tier without re-decoding — the cold-start/epoch-1 fix."""
    disk = str(tmp_path / "decoded")
    calls = []

    def decode():
        calls.append(1)
        return np.arange(48, dtype=np.float32).reshape(6, 8)

    c1 = DecodeCache(max_bytes=1 << 20, disk_dir=disk)
    first = c1.get_or_decode(("ir", "/data/x.png"), decode)
    assert len(calls) == 1
    # fresh instance, same disk dir: decode must NOT run again
    c2 = DecodeCache(max_bytes=1 << 20, disk_dir=disk)
    second = c2.get_or_decode(("ir", "/data/x.png"), decode)
    assert len(calls) == 1 and c2.disk_hits == 1
    np.testing.assert_array_equal(first, second)
    # disk-only mode (no RAM tier) also works
    c3 = DecodeCache(max_bytes=0, disk_dir=disk)
    third = c3.get_or_decode(("ir", "/data/x.png"), decode)
    assert len(calls) == 1 and c3.disk_hits == 1
    np.testing.assert_array_equal(first, third)
    # distinct keys get distinct files
    c3.get_or_decode(("ir", "/data/y.png"), decode)
    assert len(calls) == 2
    import os
    assert len(os.listdir(disk)) == 2


def test_disk_tier_end_to_end_loader_parity(tmp_path):
    """Freiburg loader through the disk tier: pixels identical to the
    uncached path in a 'fresh process' (new global config, empty RAM)."""
    from tests.synthetic import make_freiburg_tree
    from thermal_semantic_segmentation_torch.cli._common import val_transform
    from thermal_semantic_segmentation_torch.data.freiburg import Freiburg

    root = make_freiburg_tree(str(tmp_path / "freiburg"), n_train=2)
    disk = str(tmp_path / "decoded")
    ds = Freiburg(root, "train", "IR", transforms=val_transform(),
                  with_label=True)
    cold = ds.get(0, np.random.default_rng(1))
    try:
        set_decode_cache(0, disk_dir=disk)          # disk-only tier
        warm_write = ds.get(0, np.random.default_rng(1))
        set_decode_cache(0, disk_dir=None)
        set_decode_cache(0, disk_dir=disk)          # simulate fresh process
        base_hits = decode_cache().disk_hits
        warm_read = ds.get(0, np.random.default_rng(1))
        assert decode_cache().disk_hits > base_hits
        np.testing.assert_array_equal(cold["image"], warm_write["image"])
        np.testing.assert_array_equal(cold["image"], warm_read["image"])
        np.testing.assert_array_equal(cold["label"], warm_read["label"])
    finally:
        set_decode_cache(0, disk_dir=None)


def test_cli_flag_sets_disk_tier(tmp_path):
    from thermal_semantic_segmentation_torch.cli.options import seg_parse
    disk = str(tmp_path / "dc")
    try:
        seg_parse().parse_args(["--decode_cache_dir", disk])
        assert decode_cache().disk_dir == disk
    finally:
        set_decode_cache(0, disk_dir=None)


def test_resize_shrink_evicts_immediately():
    cache = DecodeCache(max_bytes=10000)
    for i in range(8):
        cache.get_or_decode(i, lambda i=i: np.full((1000,), i, np.uint8))
    cache.resize(2000)
    assert cache.nbytes <= 2000
    assert 7 in cache._entries and 0 not in cache._entries


def test_corrupt_disk_file_is_repaired_not_fatal(tmp_path):
    """A zero-byte .npy (crash between rename and data hitting disk) must
    fall back to re-decode and overwrite the corrupt file — np.load raises
    EOFError there, which once crash-looped every later run."""
    import os

    cache = DecodeCache(max_bytes=0, disk_dir=str(tmp_path / "d"))
    key = ("ir", "frame0")
    arr = cache.get_or_decode(key, lambda: np.arange(6, dtype=np.float32))
    path = cache._disk_path(key)
    open(path, "wb").close()                      # truncate to zero bytes
    assert os.path.getsize(path) == 0
    again = cache.get_or_decode(key, lambda: np.arange(6, dtype=np.float32))
    np.testing.assert_array_equal(arr, again)
    # the re-decode repaired the file: a third read hits disk cleanly
    hits = cache.disk_hits
    cache.get_or_decode(key, lambda: (_ for _ in ()).throw(AssertionError))
    assert cache.disk_hits == hits + 1


def test_resize_only_call_keeps_disk_tier(tmp_path):
    """set_decode_cache(mb) with disk_dir unset must NOT clear a previously
    configured disk tier (the docs' resize-only form silently disabled
    persistence before)."""
    disk = str(tmp_path / "keep")
    try:
        set_decode_cache(0, disk_dir=disk)
        set_decode_cache(64)                      # resize-only
        assert decode_cache().disk_dir == disk
        set_decode_cache(0, disk_dir=None)        # explicit None clears
        assert decode_cache().disk_dir is None
    finally:
        set_decode_cache(0, disk_dir=None)


def test_disk_tier_invalidates_on_newer_source(tmp_path):
    """A source file regenerated AFTER its decode was persisted (e.g. the
    translator re-writing translation PNGs after GAN retraining) must be
    re-decoded, not served stale from the disk tier."""
    import os
    import time

    disk = str(tmp_path / "decoded")
    src = tmp_path / "frame.png"
    src.write_bytes(b"v1")
    payload = {"v": np.zeros((4, 4), np.float32)}

    def decode():
        return payload["v"].copy()

    key = ("translated", str(src))
    c1 = DecodeCache(max_bytes=0, disk_dir=disk)
    first = c1.get_or_decode(key, decode)
    np.testing.assert_array_equal(first, 0)

    # regenerate the source with a strictly newer mtime than the persisted
    # decode (backdate the .npy: real runs separate the two by wall time)
    payload["v"] = np.ones((4, 4), np.float32)
    src.write_bytes(b"v2")
    past = time.time() - 10
    os.utime(c1._disk_path(key), (past, past))

    c2 = DecodeCache(max_bytes=0, disk_dir=disk)
    second = c2.get_or_decode(key, decode)
    np.testing.assert_array_equal(second, 1)   # fresh decode, not stale
    assert c2.disk_hits == 0
    # and the new decode was re-persisted: a third instance disk-hits it
    c3 = DecodeCache(max_bytes=0, disk_dir=disk)
    third = c3.get_or_decode(key, lambda: 1 / 0)
    np.testing.assert_array_equal(third, 1)
    assert c3.disk_hits == 1


def test_cli_resize_only_keeps_disk_tier(tmp_path):
    """A CLI invocation passing only --decode_cache_mb must not clear a
    previously configured disk tier: when CLIs chain in one process (the
    bench_all gates), a later stage's resize-only flag would otherwise
    silently drop persistence (set_decode_cache treats disk_dir=None as an
    explicit clear)."""
    from thermal_semantic_segmentation_torch.cli.options import seg_parse
    try:
        set_decode_cache(1, disk_dir=str(tmp_path / "tier"))
        args = seg_parse().parse_args(["--decode_cache_mb", "2"])
        assert args.decode_cache_mb == 2
        assert decode_cache().disk_dir == str(tmp_path / "tier")
        # and an explicit --decode_cache_dir still reconfigures it
        seg_parse().parse_args(["--decode_cache_mb", "2",
                                "--decode_cache_dir",
                                str(tmp_path / "other")])
        assert decode_cache().disk_dir == str(tmp_path / "other")
    finally:
        set_decode_cache(0, disk_dir=None)


@pytest.mark.parametrize("mb", [0, 64])
def test_loader_batches_with_and_without_the_cache(tmp_path, mb):
    """The port's loader over the train split (augmenting transform): the
    same batches with the RAM cache on (two epochs: decoded, then cached)
    as with it off, and as the JAX package's loader gives."""
    from tests.synthetic import make_freiburg_tree
    from thermal_semantic_segmentation_torch.cli._common import (
        train_transform)
    from thermal_semantic_segmentation_torch.data.freiburg import Freiburg
    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_tpu.cli import _common as jax_common
    from thermal_semantic_segmentation_tpu.data.freiburg import (
        Freiburg as JaxFreiburg)
    from thermal_semantic_segmentation_tpu.data.loader import (
        DataLoader as JaxDataLoader)

    root = make_freiburg_tree(str(tmp_path / "freiburg"), n_train=4)

    def epochs(ds, loader_cls):
        loader = loader_cls(ds, 2, shuffle=True, seed=3, num_threads=2)
        return [b for _ in range(2) for b in loader]

    want = epochs(JaxFreiburg(root, "train", "IR",
                              transforms=jax_common.train_transform()),
                  JaxDataLoader)
    try:
        set_decode_cache(mb)
        hits = decode_cache().hits
        got = epochs(Freiburg(root, "train", "IR",
                              transforms=train_transform()), DataLoader)
        # epoch 2 finds the 4 frames and 4 labels of epoch 1
        assert decode_cache().hits - hits == (8 if mb else 0)
    finally:
        set_decode_cache(0)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])
