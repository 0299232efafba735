"""The port's checkpoint files (vallex_tpu_torch/utils/checkpoint.py), the
checkpoint routes of `api.preload_models` and the trainer's
--init-checkpoint, and `api.continual`, against the JAX package on the CPU
at toy width.

Native npz files cross the packages in both directions with bitwise
leaves; the reference's torch checkpoint is built here from a random tree
(the inverse of the documented conversion) and written with `torch.save`,
and the port's conversion must equal the JAX package's leaf for leaf.
`continual` must give the JAX package's codes in fp32 on one random tree.
"""

import os

import jax
import numpy as np
import pytest
import torch

from vallex_tpu import api as japi
from vallex_tpu.codec import encodec as JEC
from vallex_tpu.codec import vocos as JVC
from vallex_tpu.config import EngineConfig as JEngineConfig
from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.models import vallex as JV
from vallex_tpu.utils import checkpoint as JCK
from vallex_tpu_torch import api as tapi
from vallex_tpu_torch.codec import encodec as TEC
from vallex_tpu_torch.codec.vocos import init_vocos
from vallex_tpu_torch.config import EngineConfig, ModelConfig
from vallex_tpu_torch.convert import tree_from_module
from vallex_tpu_torch.models.vallex import init_vallex
from vallex_tpu_torch.train import trainer
from vallex_tpu_torch.utils import checkpoint as TCK

torch.set_num_threads(2)

# FFN 4·D, as the trainer's model_config_from_args builds it
TINY = dict(d_model=64, num_heads=4, num_layers=2, ffn_dim=256)
TOY = ["--decoder-dim", "64", "--nhead", "4", "--num-decoder-layers", "2", "--device", "cpu"]
CFG, JCFG = ModelConfig(**TINY), JModelConfig(**TINY)
BUCKETS = dict(text_buckets=(64, 128), audio_buckets=(128, 256, 512), compute_dtype="float32")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict / list tree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        key = f"{prefix}/{k}"
        out.update(_leaves(v, key) if isinstance(v, (dict, list)) else {key: v})
    return out


def _assert_same_tree(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


@pytest.fixture(scope="module")
def jtree():
    return _np(JV.init_vallex(jax.random.PRNGKey(3), JCFG))


def _state_dict(tree, cfg):
    """The reference's state dict (module paths and torch layouts) that
    converts to `tree`: the inverse of the documented conversion."""
    sd, L, A = {}, cfg.num_layers, cfg.num_audio_tokens
    for name in ("ar_text_embedding", "nar_text_embedding", "ar_audio_embedding",
                 "ar_language_embedding", "nar_language_embedding"):
        sd[f"{name}.word_embeddings.weight"] = tree[name]["weight"]
    for name in ("ar_text_position", "ar_audio_position", "nar_text_position",
                 "nar_audio_position"):
        sd[f"{name}.alpha"] = tree[name]["alpha"].reshape(1)
    for prefix, adaptive in (("ar_decoder", False), ("nar_decoder", True)):
        lay = tree[prefix]["layers"]
        for i in range(L):
            p = f"{prefix}.layers.{i}"
            sd[f"{p}.self_attn.in_proj_weight"] = lay["self_attn"]["in_proj_w"][i].T
            sd[f"{p}.self_attn.in_proj_bias"] = lay["self_attn"]["in_proj_b"][i]
            sd[f"{p}.self_attn.out_proj.weight"] = lay["self_attn"]["out_w"][i].T
            sd[f"{p}.self_attn.out_proj.bias"] = lay["self_attn"]["out_b"][i]
            for lin in ("linear1", "linear2"):
                sd[f"{p}.{lin}.weight"] = lay[lin]["w"][i].T
                sd[f"{p}.{lin}.bias"] = lay[lin]["b"][i]
            for norm in ("norm1", "norm2"):
                n = lay[norm]
                if adaptive:
                    sd[f"{p}.{norm}.project_layer.weight"] = n["w"][i].T
                    sd[f"{p}.{norm}.project_layer.bias"] = n["b"][i]
                    sd[f"{p}.{norm}.norm.weight"] = n["scale"][i]
                    sd[f"{p}.{norm}.norm.bias"] = n["bias"][i]
                else:
                    sd[f"{p}.{norm}.weight"] = n["scale"][i]
                    sd[f"{p}.{norm}.bias"] = n["bias"][i]
        fin = tree[prefix]["norm"]
        if adaptive:
            sd[f"{prefix}.norm.project_layer.weight"] = fin["w"].T
            sd[f"{prefix}.norm.project_layer.bias"] = fin["b"]
            sd[f"{prefix}.norm.norm.weight"] = fin["scale"]
            sd[f"{prefix}.norm.norm.bias"] = fin["bias"]
        else:
            sd[f"{prefix}.norm.weight"] = fin["scale"]
            sd[f"{prefix}.norm.bias"] = fin["bias"]
    sd["ar_predict_layer.weight"] = tree["ar_predict_layer"]["w"].T
    nar = tree["nar_audio_embeddings"]["weight"]
    sd["nar_audio_embeddings.0.word_embeddings.weight"] = nar[0]
    for j in range(1, cfg.num_quantizers):
        sd[f"nar_audio_embeddings.{j}.word_embeddings.weight"] = nar[j, :A]
    for j in range(cfg.num_quantizers - 1):
        sd[f"nar_predict_layers.{j}.weight"] = tree["nar_predict_layers"]["w"][j].T
        sd[f"nar_stage_embeddings.{j}.word_embeddings.weight"] = \
            tree["nar_stage_embeddings"]["weight"][j: j + 1]
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# native npz
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["vallex", "vocos", "encodec"])
def test_native_round_trip(tmp_path, kind):
    """The port's save_native → load_native gives the tree back, torch leaves
    as numpy (bf16 ones as f32), EnCodec's list nodes as lists."""
    g = torch.Generator().manual_seed(0)
    tree = {"vallex": lambda: init_vallex(CFG, g), "vocos": lambda: init_vocos(g),
            "encodec": lambda: TEC.init_encodec(g)}[kind]()
    node, leaf = {"vallex": ("ar_text_embedding", "weight"), "vocos": ("embed", "w"),
                  "encodec": (None, "codebooks")}[kind]
    node = tree if node is None else tree[node]
    node[leaf] = node[leaf].to(torch.bfloat16)
    path = str(tmp_path / "t.npz")
    TCK.save_native(path, tree)
    back = TCK.load_native(path)
    expect = jax.tree.map(lambda t: t.float().numpy(), tree)
    _assert_same_tree(back, expect)
    if kind == "encodec":
        assert isinstance(back["encoder"]["stages"], list) and len(back["encoder"]["stages"]) == 4
        assert isinstance(back["decoder"]["lstm"], list) and len(back["decoder"]["lstm"]) == 2


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_native_npz_crosses_packages(tmp_path, jtree, direction):
    """A VALL-E or Vocos npz written by either package loads in the other,
    every leaf bitwise (same flat `/`-joined keys)."""
    vocos = _np(JVC.init_vocos(jax.random.PRNGKey(1)))
    for name, tree in (("vallex", jtree), ("vocos", vocos)):
        path = str(tmp_path / f"{name}.npz")
        save, load = ((TCK.save_native, JCK.load_native) if direction == "port_to_jax"
                      else (JCK.save_native, TCK.load_native))
        save(path, tree)
        _assert_same_tree(_np(load(path)), tree)


def test_jax_encodec_npz_is_refused(tmp_path):
    """The JAX package's save_native writes EnCodec's list nodes as pickled
    object arrays, which neither package's load_native (np.load without
    pickles) reads; the port writes one key per index instead."""
    tree = _np(JEC.init_encodec(jax.random.PRNGKey(2)))
    path = str(tmp_path / "encodec-jax.npz")
    JCK.save_native(path, tree)
    with pytest.raises(ValueError, match="allow_pickle"):
        TCK.load_native(path)
    TCK.save_native(path, tree)
    _assert_same_tree(TCK.load_native(path), tree)


# ---------------------------------------------------------------------------
# the reference's torch checkpoint
# ---------------------------------------------------------------------------

def test_convert_torch_state_dict_matches_jax(jtree):
    """convert_torch_state_dict of the port equals the JAX package's on the
    same state dict, every leaf bitwise, and inverts `_state_dict`."""
    sd = {k: v.numpy() for k, v in _state_dict(jtree, CFG).items()}
    port = TCK.convert_torch_state_dict(sd, CFG)
    _assert_same_tree(port, _np(JCK.convert_torch_state_dict(sd, JCFG)))
    _assert_same_tree(port, jtree)


@pytest.mark.parametrize("form", ["model", "bare", "bf16"])
def test_load_torch_checkpoint(tmp_path, jtree, form):
    """vallex-checkpoint.pt as {"model": state_dict}, as a bare state dict,
    and with bf16 leaves (read as their f32 values)."""
    sd = _state_dict(jtree, CFG)
    if form == "bf16":
        sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    path = str(tmp_path / "vallex-checkpoint.pt")
    torch.save(sd if form == "bare" else {"model": sd}, path)
    got = TCK.load_torch_checkpoint(path, CFG)
    if form == "bf16":
        want = TCK.convert_torch_state_dict({k: v.float().numpy() for k, v in sd.items()}, CFG)
        _assert_same_tree(got, want)
    else:
        _assert_same_tree(got, _np(JCK.load_torch_checkpoint(path, JCFG)))


# ---------------------------------------------------------------------------
# preload_models
# ---------------------------------------------------------------------------

def _preload(ckpt_dir, **kw):
    return tapi.preload_models(str(ckpt_dir), cfg=CFG, ecfg=EngineConfig(**BUCKETS),
                               device="cpu", **kw)


def test_preload_models_from_native_npz(tmp_path, jtree):
    """vallex-jax.npz (written by the JAX package) + vocos-jax.npz +
    encodec-jax.npz (written by the port) → the bundle holds those weights."""
    JCK.save_native(str(tmp_path / "vallex-jax.npz"), jtree)
    vocos = _np(JVC.init_vocos(jax.random.PRNGKey(1)))
    JCK.save_native(str(tmp_path / "vocos-jax.npz"), vocos)
    enc = _np(JEC.init_encodec(jax.random.PRNGKey(2)))
    TCK.save_native(str(tmp_path / "encodec-jax.npz"), enc)
    b = _preload(tmp_path)
    _assert_same_tree(tree_from_module(b.model), jtree)
    _assert_same_tree(tree_from_module(b.vocos), vocos)
    np.testing.assert_array_equal(b.encodec.codebooks.numpy(), enc["codebooks"])


def test_preload_models_converts_torch_checkpoint(tmp_path, jtree):
    """Only vallex-checkpoint.pt: converted, written beside it as
    vallex-jax.npz (which the JAX package loads), no Vocos or EnCodec."""
    torch.save({"model": _state_dict(jtree, CFG)}, str(tmp_path / "vallex-checkpoint.pt"))
    b = _preload(tmp_path)
    _assert_same_tree(tree_from_module(b.model), jtree)
    assert b.vocos is None and b.encodec is None
    _assert_same_tree(_np(JCK.load_native(str(tmp_path / "vallex-jax.npz"))), jtree)


def test_preload_models_npz_before_torch_checkpoint(tmp_path, jtree):
    """With both files, vallex-jax.npz wins (the JAX package's order), even
    with random_weights=True."""
    other = _np(JV.init_vallex(jax.random.PRNGKey(5), JCFG))
    JCK.save_native(str(tmp_path / "vallex-jax.npz"), jtree)
    torch.save({"model": _state_dict(other, CFG)}, str(tmp_path / "vallex-checkpoint.pt"))
    b = _preload(tmp_path, random_weights=True)
    _assert_same_tree(tree_from_module(b.model), jtree)
    assert b.vocos is None and b.encodec is None


def test_preload_models_without_checkpoint(tmp_path):
    """No file: FileNotFoundError in the JAX package's words; with
    random_weights=True a random init, Vocos (seed + 1) and EnCodec
    (seed + 2) included."""
    with pytest.raises(FileNotFoundError) as err:
        _preload(tmp_path)
    with pytest.raises(FileNotFoundError) as jerr:
        japi.preload_models(str(tmp_path), cfg=JCFG)
    assert str(err.value) == str(jerr.value)
    b = _preload(tmp_path, random_weights=True, seed=7)
    _assert_same_tree(tree_from_module(b.model),
                      jax.tree.map(lambda t: t.numpy(),
                                   init_vallex(CFG, torch.Generator().manual_seed(7))))
    want = TEC.init_encodec(torch.Generator().manual_seed(9))["codebooks"]
    assert b.vocos is not None and torch.equal(b.encodec.codebooks, want)
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# the trainer's --init-checkpoint
# ---------------------------------------------------------------------------

def _data(root, lens):
    """The toy HDF5 set of tests/test_torch_trainer.py."""
    import h5py

    rng = np.random.RandomState(0)
    d = root / "data"
    d.mkdir()
    for split in ("train", "valid"):
        with h5py.File(str(d / f"{split}.hdf5"), "w") as f:
            for i, n in enumerate(lens):
                f.create_group(f"utt{i}").create_dataset(
                    "audio", data=rng.randint(0, 1024, (8, n)))
        with open(str(d / f"{split}.txt"), "w") as f:
            for i, n in enumerate(lens):
                f.write(f"utt{i}|{n / 75:.2f}|en|tiny utterance {i}\n")
    return d


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_trainer_init_checkpoint(tmp_path, monkeypatch, jtree, suffix):
    """--init-checkpoint: a .npz through load_native, anything else through
    the torch converter; the tree goes into the model in place of the
    random init, and an epoch on the toy HDF5 set trains from it."""
    from vallex_tpu_torch import convert

    ck = str(tmp_path / f"init{suffix}")
    if suffix == ".npz":
        JCK.save_native(ck, jtree)
    else:
        torch.save({"model": _state_dict(jtree, CFG)}, ck)
    seen = []
    real = convert.load_tree

    def spy(module, tree, **kw):
        seen.append(jax.tree.map(np.asarray, tree))
        return real(module, tree, **kw)

    monkeypatch.setattr(convert, "load_tree", spy)
    d = _data(tmp_path, [24 + i for i in range(4)])
    argv = ["--data-dir", str(d), "--exp-dir", str(tmp_path / "exp"), "--num-epochs", "1",
            "--log-interval", "1", "--diag-interval", "1000", "--save-every", "1000",
            "--valid-interval", "1000", "--max-duration", "2.0", "--max-cut-duration", "2.0",
            "--init-checkpoint", ck, *TOY]
    out = trainer.run(trainer.get_parser().parse_args(argv))
    assert len(seen) == 1
    _assert_same_tree(seen[0], jtree)
    assert out["step"] >= 1 and np.isfinite(out["metrics"]["loss"])


# ---------------------------------------------------------------------------
# continual
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both(tmp_path_factory, jtree):
    d = tmp_path_factory.mktemp("ckpt")
    JCK.save_native(str(d / "vallex-jax.npz"), jtree)
    jb = japi.preload_models(str(d), cfg=JCFG, ecfg=JEngineConfig(**BUCKETS))
    tb = tapi.preload_models(params=jtree, cfg=CFG, ecfg=EngineConfig(**BUCKETS), device="cpu")
    return jb, tb


@pytest.mark.parametrize("T", [60, 500], ids=["prefix-T/2", "prefix-capped-225"])
def test_continual_matches_jax(both, monkeypatch, T):
    """api.continual against vallex_tpu.api.continual in fp32: codes equal.
    T = 500 caps the prefix at 225 frames (t_audio bucket 512); the NAR
    runs with add_lang=False."""
    jb, tb = both
    japi._bundle, tapi._bundle = jb, tb
    codes = np.random.RandomState(T).randint(0, 1024, (T, 8))
    from vallex_tpu_torch.engine import nar as TNAR

    calls = []
    real = TNAR.nar_generate

    def spy(*a, **k):
        calls.append(k["add_lang"])
        return real(*a, **k)

    monkeypatch.setattr(tapi, "nar_generate", spy)
    want = np.asarray(japi.continual("Hello there, how are you?", codes, language="en"))
    got = tapi.continual("Hello there, how are you?", codes, language="en")
    prefix = min(T // 2, 225)
    assert got.shape == want.shape == (T - prefix, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], codes[prefix:, 0])
    assert calls == [False]
