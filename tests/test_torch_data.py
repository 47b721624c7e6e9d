"""The port's training data pipeline against the JAX package's.

The same small wav tree goes through ``build_manifests``,
``SeparationDataset`` (plans and decoded batches), ``BatchLoader`` (the
shuffled order) and the segment cache of both packages; the arrays must
be equal, since both decode with the same numpy codec.
"""

import json
import os

import numpy as np
import pytest

from convtasnet_tpu.data import dataset as jds
from convtasnet_tpu.data import loader as jloader
from convtasnet_tpu.data import manifest as jman
from convtasnet_tpu.data import segment_cache as jcache
from convtasnet_tpu_torch.data import dataset as pds
from convtasnet_tpu_torch.data import loader as ploader
from convtasnet_tpu_torch.data import manifest as pman
from convtasnet_tpu_torch.data import segment_cache as pcache
from tests.test_data import _write_corpus

SR = 8000
# 0.5 s segments: one utterance shorter than a segment (dropped), one
# longer than a whole batch of 4, and tails that need re-anchoring
LENGTHS = [3000, 4000, 6100, 9000, 12500, 21000, 4000, 5200]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wavs"))
    _write_corpus(root, LENGTHS, split="tr", seed=0)
    _write_corpus(root, [4000, 9000, 16000, 7000, 20000], split="cv",
                  seed=1)
    pman.build_manifests(root, os.path.join(root, "json_port"), SR)
    jman.build_manifests(root, os.path.join(root, "json_jax"), SR)
    return root


def _plan_paths(ds):
    return [[u.paths for u in batch] for batch in ds.plan]


def _assert_batches_equal(got, want):
    for name in ("mixture", "lengths", "sources", "weights"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def test_build_manifests_match_jax(tree):
    for split in ("tr", "cv"):
        for part in ("mix", "s1", "s2"):
            with open(os.path.join(tree, "json_port", split,
                                   part + ".json")) as f:
                got = json.load(f)
            with open(os.path.join(tree, "json_jax", split,
                                   part + ".json")) as f:
                assert got == json.load(f)


@pytest.mark.parametrize("kw", [
    dict(split="tr", batch_size=4, segment=0.5),
    dict(split="tr", batch_size=3, segment=0.5, max_hours=0.0005),
    dict(split="tr", batch_size=4, segment=0.5, pad_rows_to_multiple=3),
    dict(split="cv", batch_size=2, segment=-1.0, cv_maxlen=2.0),
    dict(split="cv", batch_size=2, segment=-1.0, cv_maxlen=2.0,
         cv_skip_semantics="reference"),
], ids=["segments", "max_hours", "pad_rows", "cv-fixed", "cv-reference"])
def test_plans_and_batches_match_jax(tree, kw):
    kw = dict(kw)
    json_dir = os.path.join(tree, "json_port", kw.pop("split"))
    bs = kw.pop("batch_size")
    got = pds.SeparationDataset(json_dir, bs, SR, **kw)
    want = jds.SeparationDataset(json_dir, bs, SR, **kw)
    assert len(got) > 0
    assert _plan_paths(got) == _plan_paths(want)
    assert got.batch_shapes(400) == want.batch_shapes(400)
    for i in range(len(got)):
        _assert_batches_equal(got.load_batch(i, 400),
                              want.load_batch(i, 400))


def test_loader_order_matches_jax(tree):
    json_dir = os.path.join(tree, "json_port", "tr")
    ds = pds.SeparationDataset(json_dir, 2, SR, segment=0.5)
    got_loader = ploader.BatchLoader(ds, shuffle=True, seed=3,
                                     num_workers=2)
    want_loader = jloader.BatchLoader(
        jds.SeparationDataset(json_dir, 2, SR, segment=0.5), shuffle=True,
        seed=3, num_workers=2)
    for epoch in (0, 2):
        got_loader.set_epoch(epoch)
        want_loader.set_epoch(epoch)
        got = list(got_loader)
        want = list(want_loader)
        assert len(got) == len(want) == len(ds)
        for g, w in zip(got, want):
            assert len(g) == 4 and all(t.device.type == "cpu" for t in g)
            for gt, wt in zip(g, w):
                np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    assert list(got_loader.order()) != list(range(len(ds)))


def test_segment_cache_returns_the_same_arrays(tree, tmp_path, monkeypatch):
    json_dir = os.path.join(tree, "json_port", "tr")
    ds = pds.SeparationDataset(json_dir, 4, SR, segment=0.5)
    got = pcache.maybe_cache(ds, enable=True,
                             cache_root=str(tmp_path / "port"))
    want = jcache.maybe_cache(
        jds.SeparationDataset(json_dir, 4, SR, segment=0.5), enable=True,
        cache_root=str(tmp_path / "jax"))
    assert isinstance(got, pcache.CachedDataset)
    assert os.path.basename(got.dir) == os.path.basename(want.dir)
    first = [got.load_batch(i) for i in range(len(got))]   # decode + fill
    assert got.hit_fraction() == 1.0
    again = pcache.CachedDataset(ds, str(tmp_path / "port"))  # read back
    for i in range(len(got)):
        _assert_batches_equal(first[i], want.load_batch(i))
        _assert_batches_equal(again.load_batch(i), first[i])
    # full-utterance datasets pass through; "0" in the env turns it off
    cv = pds.SeparationDataset(os.path.join(tree, "json_port", "cv"), 1, SR,
                               segment=-1.0)
    assert pcache.maybe_cache(cv, enable=True) is cv
    monkeypatch.setenv("CONVTASNET_SEGMENT_CACHE", "0")
    assert pcache.maybe_cache(ds, enable=True) is ds
