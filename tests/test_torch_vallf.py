"""The rest of the model zoo and the training tools in the port against the
JAX package, in f32 on the CPU at toy width (d 64, 4 heads, 2 + 2 layers):
VALL-F (vallex_tpu/models/vallf.py), the debug Transformer TTS
(models/transformer_tts.py), the decoder layers they share
(models/layers.py:478-577), the scaling toolkit (models/scaling.py), the
SymbolTable, the visualizer and the trainer's --visualize-dir hook. Both
packages get the same parameter tree (convert.params_from_jax).

Tolerances: hidden states, logits, mels and losses at 1e-4 of their scale
(f32 on both sides, products summed in another order); greedy tokens, NAR
codes and frame counts exactly; the scaling forwards and their gradients
against jax.grad through the JAX custom_vjp rules at 1e-5 (max_eig where
its penalty is off; see test_max_eig_grads); the SymbolTable's strings
exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.models import layers as JL
from vallex_tpu.models import scaling as JS
from vallex_tpu.models import transformer_tts as JT
from vallex_tpu.models import vallf as JF
from vallex_tpu.utils.symbol_table import SymbolTable as JSymbolTable
from vallex_tpu_torch import models as TM
from vallex_tpu_torch.config import ModelConfig
from vallex_tpu_torch.convert import params_from_jax
from vallex_tpu_torch.models import scaling as TS
from vallex_tpu_torch.models import transformer_tts as TT
from vallex_tpu_torch.models import vallf as TF
from vallex_tpu_torch.utils.symbol_table import SymbolTable

torch.set_num_threads(2)

KW = dict(d_model=64, num_heads=4, num_layers=2, ffn_dim=128, max_position=512)
JCFG, CFG = JModelConfig(**KW), ModelConfig(**KW)
EOS = 1024


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=1e-4):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, tuple(np.shape(v))


# ---------------------------------------------------------------------------
# get_model, inits, build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, jinit, tinit", [
    ("VALL-E", "init_vallex", "init_vallex"),
    ("VALL-F", "init_vallf", "init_vallf"),
    ("Transformer", "init_transformer_tts", "init_transformer_tts"),
])
def test_get_model_trees_match_jax(name, jinit, tinit):
    """get_model returns each model's init, and the port's random tree has
    the JAX package's leaf names and shapes."""
    from vallex_tpu import models as JM

    jfn, _ = JM.get_model(name, JCFG)
    tfn, module = TM.get_model(name, CFG)
    assert jfn.__name__ == jinit and tfn.__name__ == tinit
    want = dict(_flat(_np_tree(jfn(jax.random.PRNGKey(0), JCFG))))
    got = dict(_flat({k: v for k, v in tfn(CFG, torch.Generator().manual_seed(0)).items()}))
    assert got == want
    assert params_from_jax(tfn(CFG, torch.Generator().manual_seed(0)), cfg=CFG) is not None


def test_get_model_unknown_raises():
    with pytest.raises(ValueError, match="unknown model"):
        TM.get_model("Tacotron", CFG)


@pytest.mark.parametrize("module", [TF, TT], ids=["vallf", "transformer_tts"])
def test_build_runs_on_cuda_unless_told(module):
    """build() defaults to cuda and raises without a GPU; device="cpu"
    builds on the CPU."""
    init = TF.init_vallf if module is TF else TT.init_transformer_tts
    tree = init(CFG, torch.Generator().manual_seed(0))
    m = module.build(tree, CFG, device="cpu")
    assert m.pe.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.build(tree, CFG)


# ---------------------------------------------------------------------------
# VALL-F
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vallf():
    params = JF.init_vallf(jax.random.PRNGKey(3), JCFG)
    return params, params_from_jax(_np_tree(params), cfg=CFG)


def _ar_inputs(seed=0, S=10, Tp=6, Tp_max=8):
    rng = np.random.RandomState(seed)
    text = np.zeros((1, 16), np.int32)
    text[0, :S] = rng.randint(5, 200, S)
    cb0 = np.full((1, Tp_max), EOS, np.int32)
    cb0[0, :Tp] = rng.randint(0, 1024, Tp)
    return text, S, cb0, Tp


@pytest.mark.parametrize("adaptive", [False, True], ids=["plain", "adaln"])
def test_decoder_stack_matches_jax(adaptive):
    """DecoderStack = decoder_stack_apply: self-attention under an additive
    causal + padding mask, cross-attention to a padded memory, FFN; plain
    and AdaLN norms (hidden states at 1e-4)."""
    from vallex_tpu_torch.models import layers as TL

    D, H, NL, F = 64, 4, 2, 128
    p = JL.init_decoder_stack(jax.random.PRNGKey(1), NL, D, F, adaptive)
    from vallex_tpu_torch.convert import load_tree

    stack = load_tree(TL.DecoderStack(NL, D, H, F, adaptive), _np_tree(p),
                      dtype=torch.float32, device="cpu")
    rng = np.random.RandomState(2)
    x = rng.randn(2, 12, D).astype(np.float32)
    mem = rng.randn(2, 7, D).astype(np.float32)
    rows = np.arange(12)
    self_mask = np.where(rows[None, :] <= rows[:, None], 0.0, -1e9).astype(np.float32)[None, None]
    cross_mask = np.where(np.arange(7)[None, :] < np.array([[7], [4]]), 0.0,
                          -1e9).astype(np.float32)[:, None, None, :]
    stage = rng.randn(D).astype(np.float32) if adaptive else None
    want = JL.decoder_stack_apply(p, jnp.asarray(x), jnp.asarray(mem), H,
                                  jnp.asarray(self_mask), jnp.asarray(cross_mask),
                                  None if stage is None else jnp.asarray(stage))
    got = stack(torch.from_numpy(x), torch.from_numpy(mem), torch.from_numpy(self_mask),
                torch.from_numpy(cross_mask), None if stage is None else torch.from_numpy(stage))
    _close(got, want)


def test_vallf_ar_logits_match_jax(vallf):
    """The AR's first-step hidden states and logits (the decoder over the
    buffer with text memory) at 1e-4 of their scale."""
    params, m = vallf
    text, S, cb0, Tp = _ar_inputs()
    T = 32
    y = np.full((1, T), EOS, np.int32)
    y[0, 0] = JCFG.bos_id
    y[0, 1:1 + cb0.shape[1]] = cb0[0]
    pe = JL.make_sine_pe(JCFG.max_position, JCFG.d_model)
    mem = JF._text_memory(params, JCFG, jnp.asarray(text), pe, "ar", jnp.float32)
    emb = JL.embedding_apply(params["ar_audio_embedding"], jnp.asarray(y), jnp.float32)
    y_pos = JL.sine_pe_apply(pe, params["ar_audio_position"]["alpha"], emb)
    rows = np.arange(T)
    mask = (np.where(rows[None, :] <= rows[:, None], 0.0, -1e9)
            + np.where(rows <= Tp, 0.0, -1e9)[None, :]).astype(np.float32)[None, None]
    cross = np.where(np.arange(16) < S, 0.0, -1e9).astype(np.float32)[None, None, None, :]
    jh = JL.decoder_stack_apply(params["ar_decoder"], y_pos, mem, JCFG.num_heads,
                                jnp.asarray(mask), jnp.asarray(cross))
    jlogits = jh[:, Tp] @ params["ar_predict_layer"]["w"]

    tt = torch.from_numpy(text).long()
    tmem = TF._text_memory(m, tt, "ar", torch.float32)
    ty = m.ar_audio_position(m.pe, m.ar_audio_embedding(torch.from_numpy(y).long(), torch.float32))
    th = m.ar_decoder(ty, tmem, torch.from_numpy(mask), torch.from_numpy(cross))
    _close(tmem, mem)
    _close(th, jh)
    _close(th[:, Tp] @ m.ar_predict_layer.w, jlogits)


@pytest.mark.parametrize("t_audio", [24, 40])
def test_vallf_greedy_ar_and_nar_match_jax(vallf, t_audio):
    """Greedy AR tokens and gen_len equal JAX's vallf_ar_generate; the NAR
    codes of those tokens equal vallf_nar_generate's."""
    params, m = vallf
    text, S, cb0, Tp = _ar_inputs()
    jy, jgl = JF.vallf_ar_generate(params, JCFG, jnp.asarray(text), jnp.int32(S),
                                   jnp.asarray(cb0), jnp.int32(Tp), jax.random.PRNGKey(0),
                                   jnp.float32(1.0), jnp.asarray(True), t_audio=t_audio)
    ty, tgl = TF.vallf_ar_generate(m, CFG, text, S, cb0, Tp, t_audio=t_audio)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tgl == int(jgl) > 0

    rng = np.random.RandomState(1)
    codes = np.zeros((1, t_audio, 8), np.int32)
    codes[0, :Tp] = rng.randint(0, 1024, (Tp, 8))
    gl = int(jgl)
    codes[0, Tp:Tp + gl, 0] = np.asarray(jy)[0, Tp + 1:Tp + 1 + gl]
    t_len = Tp + gl
    jc = JF.vallf_nar_generate(params, JCFG, jnp.asarray(text), jnp.int32(S), jnp.asarray(codes),
                               jnp.int32(t_len), jnp.int32(Tp), t_audio=t_audio)
    tc = TF.vallf_nar_generate(m, CFG, text, S, codes, t_len, Tp)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tc[0, :Tp].numpy(), codes[0, :Tp])


@pytest.mark.parametrize("eos_logit", [1e4, -1e4], ids=["eos-first", "eos-never"])
def test_vallf_sampled_shapes_and_eos(vallf, eos_logit):
    """Sampled mode (the PRNGs differ, so shapes and EOS only): with the
    final norm's output held at ones, the EOS logit is a constant; one that
    always wins stops after one frame, one that never wins runs to
    t_audio - 1, in both packages. Drawn tokens are audio codes."""
    params, _ = vallf
    text, S, cb0, Tp = _ar_inputs(seed=4)
    t_audio, D = 24, JCFG.d_model
    tree = _np_tree(params)
    tree["ar_decoder"]["norm"] = {"scale": np.zeros(D, np.float32),
                                  "bias": np.ones(D, np.float32)}
    w = np.array(tree["ar_predict_layer"]["w"])
    w[:, EOS] = eos_logit / D
    tree["ar_predict_layer"] = {"w": w}
    m = params_from_jax(tree, cfg=CFG)
    jy, jgl = JF.vallf_ar_generate(jax.tree.map(jnp.asarray, tree), JCFG, jnp.asarray(text),
                                   jnp.int32(S), jnp.asarray(cb0), jnp.int32(Tp),
                                   jax.random.PRNGKey(7), jnp.float32(1.0), jnp.asarray(False),
                                   t_audio=t_audio)
    ty, tgl = TF.vallf_ar_generate(m, CFG, text, S, cb0, Tp, t_audio=t_audio, greedy=False,
                                   generator=torch.Generator().manual_seed(7))
    assert ty.shape == (1, t_audio) and ty.dtype == torch.int64
    assert ty[0, 0] == CFG.bos_id
    np.testing.assert_array_equal(ty[0, 1:1 + Tp].numpy(), cb0[0, :Tp])
    gen = ty[0, Tp + 1:Tp + 1 + tgl].numpy()
    if eos_logit > 0:
        assert tgl == int(jgl) == 1 and gen.tolist() == [EOS]
    else:
        assert tgl == int(jgl) == t_audio - 1 - Tp
        assert ((gen >= 0) & (gen < EOS)).all() and len(set(gen.tolist())) > 1


# ---------------------------------------------------------------------------
# Transformer TTS
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tts():
    params = JT.init_transformer_tts(jax.random.PRNGKey(5), JCFG)
    return params, params_from_jax(_np_tree(params), cfg=CFG)


def test_transformer_tts_forward_losses_match_jax(tts):
    """forward: the masked mel MSE and the stop BCE at 1e-4 (and their sum)."""
    params, m = tts
    rng = np.random.RandomState(0)
    text = rng.randint(5, 200, (2, 9)).astype(np.int32)
    x_lens = np.array([9, 6], np.int32)
    mels = rng.randn(2, 14, 100).astype(np.float32)
    mel_lens = np.array([14, 9], np.int32)
    jl, jm = JT.forward(params, JCFG, jnp.asarray(text), jnp.asarray(x_lens),
                        jnp.asarray(mels), jnp.asarray(mel_lens))
    tl, tm = TT.forward(m, CFG, text, x_lens, mels, mel_lens)
    for k in ("mel_mse", "stop_bce"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)


@pytest.mark.parametrize("stop_bias", [None, -100.0], ids=["random-stop", "no-stop"])
def test_transformer_tts_inference_matches_jax(tts, stop_bias):
    """inference: the frame count and the mels (1e-4 of their scale), with
    the random stop head and with one that never fires (max_frames)."""
    params, m = tts
    if stop_bias is not None:
        params = dict(params, stop_layer={"w": params["stop_layer"]["w"],
                                          "b": jnp.full((1,), stop_bias)})
        m = params_from_jax(_np_tree(params), cfg=CFG)
    text = np.random.RandomState(1).randint(5, 200, (1, 8)).astype(np.int32)
    jm, jn = JT.inference(params, JCFG, jnp.asarray(text), jnp.int32(8), max_frames=12)
    tm, tn = TT.inference(m, CFG, text, 8, max_frames=12)
    assert tn == int(jn) and (stop_bias is None or tn == 12)
    _close(tm, jm)


# ---------------------------------------------------------------------------
# Scaling toolkit
# ---------------------------------------------------------------------------

def _x(shape=(3, 5, 16), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _grad(f, x, wgt, jax_side):
    """(f(x), d/dx sum(f(x) * wgt)) on one side."""
    if jax_side:
        return f(jnp.asarray(x)), jax.grad(lambda a: jnp.sum(f(a) * wgt))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = f(xt)
    (y * torch.from_numpy(wgt)).sum().backward()
    return y, xt.grad


@pytest.mark.parametrize("name", ["double_swish", "balanced_double_swish", "activation_balancer",
                                  "whiten"])
def test_scaling_functions_and_grads_match_jax(name):
    """Forward allclose; the gradient of sum(f(x) * w) against jax.grad
    through the JAX custom_vjp rules, which here change the gradient: the
    balancer's inputs put channels past its sign bound and below its
    magnitude bound, whiten's share one direction (limit 1)."""
    x = _x()
    if name in ("activation_balancer", "balanced_double_swish"):
        x[..., :4] = np.abs(x[..., :4]) + 1.0  # all positive: the sign nudge
        x[..., 4:8] *= 0.01  # tiny: the magnitude nudge
    if name == "whiten":
        x = x + 3.0 * x[..., :1]
    kw = dict(whitening_limit=1.0) if name == "whiten" else {}
    wgt = _x(x.shape, seed=1)
    jy, jg = _grad(lambda a: getattr(JS, name)(a, **kw), x, wgt, True)
    ty, tg = _grad(lambda a: getattr(TS, name)(a, **kw), x, wgt, False)
    _close(ty, jy, 1e-5)
    _close(tg, jg, 1e-5)
    if name != "double_swish":  # the rule acted
        inner = JS.double_swish if name == "balanced_double_swish" else (lambda a: a)
        _, plain = _grad(inner, x, wgt, True)
        assert np.abs(np.asarray(jg) - np.asarray(plain)).max() > 1e-6


@pytest.mark.parametrize("max_var", [1.0, -1.0], ids=["off", "on"])
def test_max_eig_grads(max_var):
    """max_eig's direction is the normalised column sum of rows it has just
    centred (vallex_tpu/models/scaling.py:202-205): zero up to rounding, so
    where it points is set by rounding in either package. With
    max_var_per_eig = 1 the penalty is off in both by construction (the
    variance share is at most 1) and the gradient equals JAX's at 1e-5;
    with -1 it is on in both: the port's gradient is finite and moved."""
    x = _x() + 3.0 * _x()[..., :1]
    wgt = _x(x.shape, seed=1)
    jy, jg = _grad(lambda a: JS.max_eig(a, max_var_per_eig=max_var), x, wgt, True)
    ty, tg = _grad(lambda a: TS.max_eig(a, max_var_per_eig=max_var), x, wgt, False)
    _close(ty, jy, 1e-5)
    if max_var > 0:
        _close(tg, jg, 1e-5)
        np.testing.assert_array_equal(tg.numpy(), wgt)
    else:
        assert torch.isfinite(tg).all() and (tg - torch.from_numpy(wgt)).abs().max() > 1e-6


@pytest.mark.parametrize("kind", ["basic", "balanced", "identity"])
def test_scaling_norms_match_jax(kind):
    """BasicNorm / BalancedBasicNorm / IdentityNorm: outputs and the
    gradients of x and eps_log against jax.grad at 1e-5."""
    x = _x(seed=2)
    wgt = _x(seed=3)
    jp = {"basic": JS.init_basic_norm(0.3), "balanced": JS.init_balanced_basic_norm(0.3),
          "identity": JS.init_identity_norm()}[kind]
    japply = {"basic": JS.basic_norm_apply, "balanced": JS.balanced_basic_norm_apply,
              "identity": JS.identity_norm_apply}[kind]
    norm = {"basic": lambda: TS.BasicNorm(0.3), "balanced": lambda: TS.BalancedBasicNorm(0.3),
            "identity": TS.IdentityNorm}[kind]()
    jy = japply(jp, jnp.asarray(x))
    jgx, jgp = jax.grad(lambda a, p: jnp.sum(japply(p, a) * wgt), argnums=(0, 1))(
        jnp.asarray(x), jp)
    xt = torch.from_numpy(x).requires_grad_(True)
    ty = norm(xt)
    (ty * torch.from_numpy(wgt)).sum().backward()
    _close(ty, jy, 1e-5)
    _close(xt.grad, jgx, 1e-5)
    if kind != "identity":
        np.testing.assert_allclose(float(norm.eps_log.grad), float(jgp["eps_log"]), rtol=1e-4)


def test_scaled_linear_matches_jax():
    """ScaledLinear: the output, the effective weight and every gradient
    against jax.grad at 1e-5 (initial_scale 0.5)."""
    jp = JS.init_scaled_linear(jax.random.PRNGKey(0), 16, 8, initial_scale=0.5)
    lin = TS.ScaledLinear(16, 8, initial_scale=0.5)
    with torch.no_grad():
        for k in ("w", "b", "w_scale_log", "b_scale_log"):
            getattr(lin, k).copy_(torch.from_numpy(np.array(jp[k])))
    x, wgt = _x((4, 16)), _x((4, 8), seed=1)
    jgx, jgp = jax.grad(lambda a, p: jnp.sum(JS.scaled_linear_apply(p, a) * wgt),
                        argnums=(0, 1))(jnp.asarray(x), jp)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = lin(xt)
    (y * torch.from_numpy(wgt)).sum().backward()
    _close(y, JS.scaled_linear_apply(jp, jnp.asarray(x)), 1e-5)
    _close(lin.effective_weight(), JS.scaled_linear_effective_weight(jp), 1e-6)
    _close(xt.grad, jgx, 1e-5)
    for k in ("w", "b", "w_scale_log", "b_scale_log"):
        _close(getattr(lin, k).grad, jgp[k], 1e-5)


# ---------------------------------------------------------------------------
# SymbolTable, visualizer, trainer
# ---------------------------------------------------------------------------

TABLE = "<eps> 0\na 1\nb 2\n\nzh 7\n"


def test_symbol_table_round_trip_equals_jax(tmp_path):
    """from_str → to_str, ids, symbols, add, merge and the file round trip
    give the JAX package's strings."""
    j, t = JSymbolTable.from_str(TABLE), SymbolTable.from_str(TABLE)
    assert t.to_str() == j.to_str() and t.ids == j.ids and t.symbols == j.symbols
    assert t.add("c") == j.add("c") and t["c"] == j["c"] and t[7] == j[7] == "zh"
    other = "<eps> 0\nd 9\na 1\n"
    assert (t.merge(SymbolTable.from_str(other)).to_str()
            == j.merge(JSymbolTable.from_str(other)).to_str())
    t.to_file(str(tmp_path / "t.txt"))
    j.to_file(str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert SymbolTable.from_file(str(tmp_path / "t.txt")) == t
    for bad in ("a 1 2", "a 1\nb 1"):
        with pytest.raises(ValueError):
            SymbolTable.from_str(bad)
    with pytest.raises(ValueError, match="id 1"):
        t.merge(SymbolTable.from_str("q 1"))


def test_visualize_writes_pngs(tmp_path):
    """visualize writes the JAX package's file names, from tensors too."""
    pytest.importorskip("matplotlib")
    from vallex_tpu_torch.utils.visualizer import visualize

    enc, dec = torch.randn(2, 5, 8), torch.randn(2, 7, 8)
    codes = np.random.RandomState(0).randint(0, 1024, (2, 7, 8))
    visualize((enc, dec), {"codes": codes, "utt_ids": ["u0", "u1"]}, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"u{i}_{k}.png" for i in range(2) for k in ("encoder", "decoder", "codes"))


def test_visualize_without_matplotlib_names_it(monkeypatch, tmp_path):
    import builtins

    from vallex_tpu_torch.utils import visualizer

    real = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.startswith("matplotlib"):
            raise ImportError("No module named 'matplotlib'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(ImportError, match="matplotlib"):
        visualizer.visualize((np.zeros((1, 2, 3)), np.zeros((1, 2, 3))), {}, str(tmp_path))


def _trainer_args(tmp_path, *extra):
    from test_torch_trainer import TOY, _data
    from vallex_tpu_torch.train import trainer

    d = _data(tmp_path, [24 + i for i in range(4)])
    return trainer, trainer.get_parser().parse_args(
        ["--data-dir", str(d), "--exp-dir", str(tmp_path / "exp"), "--num-epochs", "1",
         "--log-interval", "1", "--diag-interval", "1000", "--save-every", "1000",
         "--valid-interval", "1", "--max-duration", "2.0", "--max-cut-duration", "2.0",
         "--optimizer", "adamw", *TOY, *extra])


def test_trainer_visualize_dir(tmp_path):
    """One validation with --visualize-dir writes the first validation
    batch's heatmaps (debug_activations), as the JAX trainer does."""
    pytest.importorskip("matplotlib")
    trainer, args = _trainer_args(tmp_path, "--visualize-dir", str(tmp_path / "viz"))
    out = trainer.run(args)
    assert out["step"] >= 1 and np.isfinite(out["metrics"]["loss"])
    pngs = sorted(os.listdir(tmp_path / "viz"))
    assert pngs and all(p.endswith(("_encoder.png", "_decoder.png", "_codes.png"))
                        for p in pngs)
    assert {p.rsplit("_", 1)[0] for p in pngs} <= {f"utt{i}" for i in range(4)}


@pytest.mark.parametrize("name", ["VALL-F", "Transformer"])
def test_trainer_model_without_a_loss_raises(tmp_path, name):
    """VALL-F and the Transformer TTS have no training objective (the JAX
    trainer fails inside total_loss): the trainer raises when it is built,
    before it writes anything."""
    trainer, args = _trainer_args(tmp_path, "--model-name", name)
    with pytest.raises(ValueError, match="VALL-E's"):
        trainer.run(args)
    assert not os.path.exists(tmp_path / "exp")
