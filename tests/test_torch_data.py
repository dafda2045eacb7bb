"""Port parity: ``acvae_tpu_torch.data`` (tokenize, build_vocab,
load_caption_info, the synthetic corpora, the dataset and loader) and the
CLI's ``_train_val_split`` against ``acvae_tpu``.  Every comparison is
exact."""
import copy
import csv
import json

import h5py
import numpy as np
import pytest

from acvae_tpu.cli.main import _train_val_split as j_split
from acvae_tpu.data import dataset as jds
from acvae_tpu.data import synthetic as jsyn
from acvae_tpu.data import vocab as jvocab
from acvae_tpu_torch.cli.main import (_feature_source, _read_manifest,
                                      _train_val_split)
from acvae_tpu_torch.data import dataset as tds
from acvae_tpu_torch.data import synthetic as tsyn
from acvae_tpu_torch.data import vocab as tvocab

CAPTIONS = [
    "A dog barks (loudly),then stops.", "  Rain: falling; on 'the' roof!? ",
    'He said "hello" twice', "UPPER lower MiXeD", "",
    "雨滴落在屋顶上，然后停了。", "一只dog在叫（很响）", "风吹 过 树叶！abc,def",
    "全角：ＡＢＣ　空格", "tab\tseparated\nlines",
]


@pytest.mark.parametrize("zh", [False, True], ids=["en", "zh"])
def test_tokenize_matches_jax(zh):
    for cap in CAPTIONS:
        assert tvocab.tokenize(cap, zh) == jvocab.tokenize(cap, zh), cap


def _info():
    _, info, _ = jsyn.make_synthetic_clotho_rich(num_audios=30, seed=5)
    info[0]["captions"][0]["tokens"] = "pre tokenized words"
    info[1]["captions"].append({"cap_id": 9, "caption": "A rare, rare word!"})
    return info


@pytest.mark.parametrize("threshold,pad", [(1, 1), (3, 1), (1, 8), (2, 7)])
def test_build_vocab_matches_jax(threshold, pad):
    a, b = _info(), _info()
    va = tvocab.build_vocab(a, threshold, pad_to_multiple=pad)
    vb = jvocab.build_vocab(b, threshold, pad_to_multiple=pad)
    assert va.word2idx == vb.word2idx and len(va) % pad == 0
    assert a == b                       # tokens written back alike
    za = tvocab.build_vocab([{"captions": [{"caption": c}]} for c in CAPTIONS],
                            zh=True)
    zb = jvocab.build_vocab([{"captions": [{"caption": c}]} for c in CAPTIONS],
                            zh=True)
    assert za.word2idx == zb.word2idx


@pytest.mark.parametrize("zh", [False, True], ids=["en", "zh"])
def test_load_caption_info_matches_jax(tmp_path, zh):
    info = [{"audio_id": f"a{i}", "captions": [{"caption": c, "cap_id": 1}]}
            for i, c in enumerate(CAPTIONS)]
    info[0]["captions"][0]["tokens"] = "kept as is"
    info.append({"audio_id": "none"})
    (tmp_path / "text.json").write_text(json.dumps({"audios": info}))
    path = str(tmp_path / "text.json")
    assert tvocab.load_caption_info(path, zh) == jvocab.load_caption_info(path, zh)


@pytest.mark.parametrize("rich", [False, True], ids=["small", "rich"])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_corpora_match_jax(rich, seed):
    gen = "make_synthetic_clotho_rich" if rich else "make_synthetic_clotho"
    kw = dict(num_audios=25, captions_per_audio=4, mel_frames=300, mel_bins=48,
              seed=seed)
    fa, ia, va = getattr(tsyn, gen)(**kw)
    fb, ib, vb = getattr(jsyn, gen)(**kw)
    assert list(fa) == list(fb) and ia == ib and va.word2idx == vb.word2idx
    for k in fb:
        assert fa[k].dtype == fb[k].dtype and fa[k].tobytes() == fb[k].tobytes()


@pytest.mark.parametrize("percent,seed", [(90.0, 1), (80, 3), (50.5, 0)])
def test_train_val_split_matches_jax(percent, seed):
    info = [{"audio_id": str(i)} for i in range(37)]
    assert _train_val_split(info, percent, seed) == j_split(info, percent, seed)


# --------------------------------------------------------------------- #
# dataset and loader
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A rich corpus written twice with the same arrays: an .npz store (the
    port's make_synthetic) and an HDF5 one (the JAX package's), each with
    its TSV manifest; one clip is stored [1, T, F] to exercise the squeeze."""
    root = tmp_path_factory.mktemp("corpus")
    feats, info, vocab = jsyn.make_synthetic_clotho_rich(
        num_audios=22, mel_frames=600, mel_bins=16, seed=2)
    first = next(iter(feats))
    feats[first] = feats[first][None]
    np.savez(root / "mels.npz", **feats)
    with h5py.File(root / "mels.h5", "w") as f:
        for aid, mel in feats.items():
            f[aid] = mel
    for name in ("npz", "h5"):
        with open(root / f"{name}.csv", "w", newline="") as f:
            w = csv.writer(f, delimiter="\t", lineterminator="\n")
            w.writerow(["audio_id", "hdf5_path"])
            w.writerows([aid, str(root / f"mels.{name}")] for aid in feats)
    return root, info, vocab


def _batches(loader, epochs, skip):
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        for b in loader.prefetch(skip_batches=skip if epoch == epochs[0] else 0):
            out.append((b.feats, b.feat_lens, b.caps, b.cap_lens, b.audio_ids,
                        b.cap_indices, b.cap_ids))
    return out


@pytest.mark.parametrize("store", ["npz", "h5"])
@pytest.mark.parametrize("drop_last,skip,bs", [(False, 0, 16), (True, 0, 16),
                                               (True, 2, 12), (False, 3, 7)])
def test_loader_batches_match_jax(corpus, store, drop_last, skip, bs):
    """Two shuffled epochs with small buckets (some clips cropped): every
    array and id of every batch equal to the JAX loader's over the HDF5
    store."""
    root, info, vocab = corpus
    buckets = (128, 256, 384)
    jvoc = jvocab.Vocabulary.load(_save_vocab(vocab, root))
    ref_ds = jds.CaptionDataset(h5file_dict=_read_manifest(str(root / "h5.csv")),
                                caption_info=copy.deepcopy(info),
                                vocabulary=jvoc)
    ds = tds.CaptionDataset(_read_manifest(str(root / f"{store}.csv")),
                            copy.deepcopy(info),
                            tvocab.Vocabulary.load(str(root / "vocab.pkl")))
    assert ds.data_dim == ref_ds.data_dim == 16 and len(ds) == len(ref_ds)
    assert ds.refs() == ref_ds.refs()
    kw = dict(shuffle=True, seed=4, buckets=buckets, drop_last=drop_last)
    loader = tds.CaptionLoader(ds, bs, **kw)
    ref = jds.CaptionLoader(ref_ds, bs, **kw)
    assert len(loader) == len(ref)
    got, want = _batches(loader, [3, 4], skip), _batches(ref, [3, 4], skip)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            else:
                assert a == b
    assert any(b[0].shape[1] == buckets[-1] for b in got)


def _save_vocab(vocab, root):
    path = str(root / "vocab.pkl")
    vocab.save(path)
    return path


def test_loader_unsorted_and_stage(corpus):
    """Unshuffled order, ``stage`` runs on each batch, a producer error
    reaches the consumer, and ``pick_bucket`` equals JAX's."""
    root, info, vocab = corpus
    ds = tds.CaptionDataset(_read_manifest(str(root / "npz.csv")),
                            copy.deepcopy(info),
                            tvocab.Vocabulary.load(_save_vocab(vocab, root)))
    loader = tds.CaptionLoader(ds, 32)
    ids = [aid for b in loader.prefetch(stage=lambda b: b.audio_ids) for aid in b]
    assert ids == [info[ai]["audio_id"] for ai, _ in ds.pairs]

    def boom(b):
        raise KeyError("staged")
    with pytest.raises(KeyError, match="staged"):
        list(loader.prefetch(stage=boom))
    for n in (1, 255, 256, 257, 3072, 5000):
        assert tds.pick_bucket(n, tds.DEFAULT_BUCKETS) == jds.pick_bucket(
            n, jds.DEFAULT_BUCKETS)
    assert tds.DEFAULT_BUCKETS == jds.DEFAULT_BUCKETS


def test_later_items_raise(corpus, monkeypatch):
    """Caption embeddings and a multi-host loader raise naming their ROADMAP
    items; kaldi ``.scp``/``.ark`` tables (written by the JAX package's
    writer) read through ``_feature_source`` into the clips' arrays, and
    the port's writer writes the same bytes; without h5py an HDF5 store
    names h5py and the .npz route."""
    import sys

    from acvae_tpu.data.kaldi import write_mat_ark as j_write
    from acvae_tpu_torch.data.kaldi import write_mat_ark

    root, info, vocab = corpus
    with pytest.raises(NotImplementedError, match="A17"):
        tds.CaptionDataset(caption_info=info, features={}, embedding_path="e")
    ds = tds.CaptionDataset(_read_manifest(str(root / "npz.csv")), info,
                            tvocab.Vocabulary())
    with pytest.raises(NotImplementedError, match="A19"):
        tds.CaptionLoader(ds, 4, host_count=2)
    mats = {aid: np.load(root / "mels.npz")[aid].squeeze() for aid in
            _read_manifest(str(root / "npz.csv"))}
    mats["f64"] = mats[next(iter(mats))].astype(np.float64)
    j_write(str(root / "feats.ark"), mats, str(root / "feats.scp"))
    write_mat_ark(str(root / "port.ark"), mats, str(root / "port.scp"))
    assert (root / "port.ark").read_bytes() == (root / "feats.ark").read_bytes()
    assert (root / "port.scp").read_text() == (root / "feats.scp").read_text(
        ).replace("feats.ark", "port.ark")
    for suffix in ("scp", "ark"):
        src = _feature_source(str(root / f"feats.{suffix}"))
        assert list(src) == ["features"] and list(src["features"]) == list(mats)
        for aid, mat in mats.items():
            got = src["features"][aid]
            assert got.dtype == mat.dtype and np.array_equal(got, mat), aid
    ds = tds.CaptionDataset(**_feature_source(str(root / "feats.scp")),
                            caption_info=info, vocabulary=tvocab.Vocabulary())
    ref = tds.CaptionDataset(_read_manifest(str(root / "npz.csv")), info,
                             tvocab.Vocabulary())
    for i in range(len(ref)):
        assert np.array_equal(ds.get(i)[1], ref.get(i)[1])
    # without h5py an HDF5 store names h5py and the .npz route
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py.*npz"):
        tds.CaptionDataset(_read_manifest(str(root / "h5.csv")), info,
                           tvocab.Vocabulary())
