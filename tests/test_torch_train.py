"""The port's training path against the JAX package, in f32 on the CPU at
toy width (TINY of tests/test_train.py): losses and every gradient leaf,
the collates, the prompt samplers, the optimizers against optax, a train
step that overfits, and two-stage freezing.

The JAX side runs its mask path (use_flash=False); tests/test_train.py
holds that path equal to its flash path, and tests/test_torch_flash.py
holds the port's flash attention equal to the interpreted JAX kernels. The
port runs both of its routes (the flash route takes the kernels' plain
versions on the CPU). Both packages get the same parameter tree.

Tolerances: losses at 1e-5; gradients at rtol = atol = 2e-3 (as
tests/test_train.py:417-421); the packed loss against the unpacked one
within 2e-3 (as tests/test_train.py:424-486); optimizer parameters at 1e-6
and schedules at 1e-6 relative (f32 on both sides); collates exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.data import dataset as JD
from vallex_tpu.models import layers as JL
from vallex_tpu.models import vallex as JV
from vallex_tpu.train import loss as JLoss
from vallex_tpu.train import scaled_adam as JSA
from vallex_tpu.train import step as JStep
from vallex_tpu_torch.config import ModelConfig
from vallex_tpu_torch.convert import params_from_jax, tree_from_module
from vallex_tpu_torch.data import dataset as TD
from vallex_tpu_torch.models import vallex as TV
from vallex_tpu_torch.train import loss as TLoss
from vallex_tpu_torch.train import scaled_adam as TSA
from vallex_tpu_torch.train import step as TStep

torch.set_num_threads(2)

KW = dict(d_model=64, num_heads=4, num_layers=2, ffn_dim=128, max_position=256)
JCFG, CFG = JModelConfig(**KW), ModelConfig(**KW)
B, S, T = 2, 12, 24
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def jparams():
    return JV.init_vallex(jax.random.PRNGKey(0), JCFG)


def _model(jparams):
    m = params_from_jax(jax.tree.map(np.asarray, jparams), cfg=CFG)
    return m.requires_grad_(True)


def _batch():
    rng = np.random.RandomState(0)
    return {
        "text_ids": rng.randint(5, 99, (B, S)).astype(np.int32),
        "lang_ids": np.zeros((B, S), np.int32),
        "text_lens": np.array([S, S - 3], np.int32),
        "codes": rng.randint(0, 1024, (B, T, 8)).astype(np.int32),
        "audio_lens": np.array([T, T - 6], np.int32),
        "prompt_codes": rng.randint(0, 1024, (B, 6, 8)).astype(np.int32),
    }


def _tt(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jt(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_tree_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], f"{path}.{k}")
        return
    np.testing.assert_allclose(got, np.asarray(want), err_msg=path, **GRAD_TOL)


def _port_loss_and_grads(m, fn):
    m.zero_grad(set_to_none=True)
    loss = fn(m)
    loss.backward()
    return float(loss.detach()), tree_from_module(m, grad=True)


_JAX_CACHE = {}


def _jax_loss_and_grads(key, jparams, fn):
    if key not in _JAX_CACHE:
        loss, grads = jax.jit(jax.value_and_grad(fn))(jparams)
        _JAX_CACHE[key] = (float(loss), grads)
    return _JAX_CACHE[key]


@pytest.mark.parametrize("use_flash", [False, True])
def test_ar_loss_and_grads_match_jax(jparams, use_flash):
    b, pe = _batch(), JL.make_sine_pe(JCFG.max_position, JCFG.d_model)
    jb, tb = _jt(b), _tt(b)
    want_loss, want_grads = _jax_loss_and_grads("ar", jparams, lambda p: JLoss.ar_loss(
        p, JCFG, jb["text_ids"], jb["lang_ids"], jb["text_lens"], jb["codes"][..., 0],
        jb["audio_lens"], pe, jnp.float32, use_flash=False))
    loss, grads = _port_loss_and_grads(_model(jparams), lambda m: TLoss.ar_loss(
        m, CFG, tb["text_ids"], tb["lang_ids"], tb["text_lens"], tb["codes"][..., 0],
        tb["audio_lens"], torch.float32, use_flash=use_flash))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)
    _assert_tree_close(grads, want_grads)


NAR_CASES = {0: (3, 0, None), 1: (2, 5, None), 2: (5, 4, [2, 7]), 4: (6, 0, None)}


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("mode", [0, 1, 2, 4])
def test_nar_loss_and_grads_match_jax(jparams, mode, use_flash):
    stage, prefix_len, starts = NAR_CASES[mode]
    b, pe = _batch(), JL.make_sine_pe(JCFG.max_position, JCFG.d_model)
    jb, tb = _jt(b), _tt(b)
    jstarts = None if starts is None else jnp.asarray(starts, jnp.int32)
    tstarts = None if starts is None else torch.tensor(starts)
    want_loss, want_grads = _jax_loss_and_grads(("nar", mode), jparams, lambda p: JLoss.nar_loss(
        p, JCFG, jb["text_ids"], jb["lang_ids"], jb["text_lens"], jb["codes"],
        jb["audio_lens"], jnp.asarray(stage), jnp.asarray(prefix_len), pe, jnp.float32,
        prefix_mode=mode, prompt_codes=jb["prompt_codes"] if mode == 4 else None,
        prompt_starts=jstarts, use_flash=False))
    loss, grads = _port_loss_and_grads(_model(jparams), lambda m: TLoss.nar_loss(
        m, CFG, tb["text_ids"], tb["lang_ids"], tb["text_lens"], tb["codes"],
        tb["audio_lens"], stage, prefix_len, torch.float32, prefix_mode=mode,
        prompt_codes=tb["prompt_codes"] if mode == 4 else None, prompt_starts=tstarts,
        use_flash=use_flash))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)
    _assert_tree_close(grads, want_grads)


def test_debug_activations_match_jax(jparams):
    """The visualizer's teacher-forced AR hidden states, text and audio
    halves, at 1e-4 (f32 on both sides)."""
    b = _batch()
    want = JLoss.debug_activations(jparams, JCFG, _jt(b), jnp.float32)
    got = TLoss.debug_activations(_model(jparams), CFG, _tt(b), torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def _samples(seed, lens_t, lens_a, language=0):
    rng = np.random.RandomState(seed)
    return [{
        "utt_id": f"u{i}",
        "text_tokens": rng.randint(5, 99, (sl,)).astype(np.int32),
        "text_tokens_lens": sl,
        "language": language,
        "audio_features": rng.randint(0, 1024, (8, al)).astype(np.int32),
        "audio_features_lens": al,
    } for i, (sl, al) in enumerate(zip(lens_t, lens_a))]


def test_collates_equal_jax():
    samples = _samples(3, [10, 40, 23, 31, 17], [100, 20, 90, 30, 301], language=1)
    for want, got in ((JD.collate(samples), TD.collate(samples)),
                      (JD.collate_packed(samples, pack=2), TD.collate_packed(samples, pack=2)),
                      (JD.collate_packed(samples, pack=3), TD.collate_packed(samples, pack=3))):
        assert set(want) == set(got)
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert want[k].dtype == got[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                assert got[k] == want[k], k


@pytest.mark.parametrize("mode", [1, 0])
def test_packed_loss_matches_unpacked_jax(jparams, mode):
    """total_loss_packed's two halves (the flash route, with segment ids)
    against the JAX package's unpacked mask path over the same utterances,
    at the same stage and prefix length, prefix modes 1 and 0."""
    lens_t, lens_a = [40, 23, 31, 17], [60, 29, 44, 51]
    samples = _samples(11, lens_t, lens_a)
    Sm, Tm, n = max(lens_t), max(lens_a), len(samples)
    text_ids = np.full((n, Sm), 3, np.int32)
    codes = np.zeros((n, Tm, 8), np.int32)
    for i, s in enumerate(samples):
        text_ids[i, :lens_t[i]] = s["text_tokens"]
        codes[i, :lens_a[i]] = s["audio_features"].T
    jb = _jt({"text_ids": text_ids, "lang_ids": np.zeros((n, Sm), np.int32),
              "text_lens": np.array(lens_t, np.int32), "codes": codes,
              "audio_lens": np.array(lens_a, np.int32)})
    pe = JL.make_sine_pe(JCFG.max_position, JCFG.d_model)
    stage, prefix_len = 3, (4 if mode == 1 else 0)
    want = float(JLoss.ar_loss(jparams, JCFG, jb["text_ids"], jb["lang_ids"], jb["text_lens"],
                               jb["codes"][..., 0], jb["audio_lens"], pe, jnp.float32)
                 + JLoss.nar_loss(jparams, JCFG, jb["text_ids"], jb["lang_ids"],
                                  jb["text_lens"], jb["codes"], jb["audio_lens"],
                                  jnp.asarray(stage), jnp.asarray(prefix_len), pe,
                                  jnp.float32, prefix_mode=mode))
    m = _model(jparams)
    packed = {k: torch.from_numpy(v) for k, v in TD.collate_packed(samples, pack=2).items()
              if isinstance(v, np.ndarray)}
    with torch.no_grad():
        got = float(TLoss.ar_loss_packed(m, CFG, packed, torch.float32)
                    + TLoss.nar_loss_packed(m, CFG, packed, stage, prefix_len, torch.float32,
                                            prefix_mode=mode))
    assert abs(got - want) < 2e-3, (got, want)


def test_total_loss_routes_and_draws(jparams):
    """total_loss draws the stage in [1, 7] and routes "auto" by the JAX
    rule: the same draws give the same loss on every route."""
    m, b = _model(jparams), _tt(_batch())
    with torch.no_grad():
        losses = [float(TLoss.total_loss(m, CFG, b, torch.Generator().manual_seed(5),
                                         torch.float32, 1, fl)[0])
                  for fl in (False, True, "auto")]
    np.testing.assert_allclose(losses, losses[0], rtol=1e-5)
    assert not TLoss._use_flash("auto", b)  # 24 frames < 800
    assert TLoss._use_flash("auto", {"codes": torch.zeros(1, 800, 8)})
    stages = {TLoss._draw_stage(g, CFG) for g in
              (torch.Generator().manual_seed(s) for s in range(200))}
    assert stages == set(range(1, 8))


def test_mode2_window_sampler_in_bounds():
    """Per-utterance window starts stay in [0, len_b − prefix_len], whose
    upper end is reachable (reference: random.Random.randint)."""
    audio_lens = torch.tensor([100, 40, 64])
    g = torch.Generator().manual_seed(0)
    hits_upper = False
    for _ in range(50):
        prefix_len, starts = TLoss.sample_nar_prompt(g, audio_lens, 2)
        assert prefix_len == 10  # min(225, 40 // 4)
        assert (starts >= 0).all() and (starts <= audio_lens - 10).all()
        hits_upper |= bool((starts == audio_lens - 10).any())
    assert hits_upper


def test_mode1_sampler_matches_reference_distribution():
    """prefix_len ~ U[0, 2·⌊min/4⌋), capped at 225."""
    audio_lens = torch.tensor([600, 480])  # min // 4 = 120
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(200):
        prefix_len, starts = TLoss.sample_nar_prompt(g, audio_lens, 1)
        assert starts is None and 0 <= prefix_len <= 225
        seen.add(prefix_len)
    assert max(seen) > 120 and 225 in seen  # the range is 2·int_low, capped
    assert TLoss.sample_nar_prompt(g, audio_lens, 0) == (0, None)


# --------------------------------------------------------------------------
# optimizers against optax
# --------------------------------------------------------------------------

def _opt_tree(seed):
    """A small tree with a stacked leaf ([2, 4, 3], as the layer stacks),
    a bias and a scalar."""
    rng = np.random.RandomState(seed)
    return {"w": rng.standard_normal((2, 4, 3)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32),
            "alpha": np.float32(1.3)}


def _port_leaves(tree):
    w = [torch.tensor(tree["w"][i]) for i in range(2)]
    return [TStep.Leaf("alpha", (torch.tensor(tree["alpha"]),), 0),
            TStep.Leaf("b", (torch.tensor(tree["b"]),), 1),
            TStep.Leaf("w", tuple(w), 3)]


def _port_tree(leaves):
    by = {leaf.name: leaf.params for leaf in leaves}
    return {"alpha": by["alpha"][0].numpy(), "b": by["b"][0].numpy(),
            "w": torch.stack(by["w"]).numpy()}


OPTIMIZERS = {
    "adamw": (lambda: JStep.make_optimizer(base_lr=0.1, warmup=2.0),
              lambda: TStep.make_optimizer(base_lr=0.1, warmup=2.0)),
    "scaled_adam": (lambda: JSA.scaled_adam(JSA.eden_schedule(0.1, warmup=2.0)),
                    lambda: TSA.scaled_adam(TSA.eden_schedule(0.1, warmup=2.0))),
    "eve": (lambda: JSA.eve(JSA.eden_schedule(0.1, warmup=2.0), weight_decay=0.1),
            lambda: TSA.eve(TSA.eden_schedule(0.1, warmup=2.0), weight_decay=0.1)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """Three updates on the same gradients (the first two above the
    clipping norms, the third below) give the same parameters."""
    make_j, make_t = OPTIMIZERS[name]
    jopt, topt = make_j(), make_t()
    tree = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jp)
    leaves = _port_leaves(tree)
    tstate = topt.init(leaves)
    rng = np.random.RandomState(1)
    for scale in (5.0, 3.0, 0.05):
        g = {k: (scale * rng.standard_normal(np.shape(v))).astype(np.float32)
             for k, v in tree.items()}
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tg = [[torch.tensor(g[leaf.name])] if leaf.name != "w"
              else [torch.tensor(g["w"][i]) for i in range(2)] for leaf in leaves]
        tstate = topt.apply(leaves, tg, tstate)
        got = _port_tree(leaves)
        for k in tree:
            np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} {k}")


def test_masked_optimizer_matches_multi_transform():
    """Masked(AdamW) = optax.multi_transform({train: adamw chain, freeze:
    set_to_zero}): the clipping norm covers the trained leaves only and the
    frozen leaf stays bitwise as it was."""
    tree = _opt_tree(2)
    labels = {"alpha": "freeze", "b": "train", "w": "train"}
    jopt = optax.multi_transform({"train": JStep.make_optimizer(base_lr=0.1, warmup=2.0),
                                  "freeze": optax.set_to_zero()}, labels)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jp)
    leaves = _port_leaves(tree)
    topt = TStep.Masked(TStep.make_optimizer(base_lr=0.1, warmup=2.0),
                        [labels[leaf.name] == "train" for leaf in leaves])
    tstate = topt.init(leaves)
    rng = np.random.RandomState(3)
    for _ in range(3):
        g = {k: (4.0 * rng.standard_normal(np.shape(v))).astype(np.float32)
             for k, v in tree.items()}
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tg = [[torch.tensor(g[leaf.name])] if leaf.name != "w"
              else [torch.tensor(g["w"][i]) for i in range(2)] for leaf in leaves]
        tstate = topt.apply(leaves, tg, tstate)
    got = _port_tree(leaves)
    for k in tree:
        np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=1e-6, atol=1e-6, err_msg=k)
    assert got["alpha"] == tree["alpha"]


@pytest.mark.parametrize("step", [0, 1, 499, 500, 5000])
def test_schedules_match_jax(step):
    pairs = [(JStep.eden_schedule(0.05), TStep.eden_schedule(0.05)),
             (JSA.eden_schedule(0.05), TSA.eden_schedule(0.05)),
             (JSA.noam_schedule(0.05), TSA.noam_schedule(0.05))]
    for jf, tf in pairs:
        np.testing.assert_allclose(tf(step), float(jf(jnp.asarray(step))), rtol=1e-6)


def test_grad_diagnostics_match_jax():
    tree = _opt_tree(4)
    jd = JSA.grad_diagnostics(jax.tree.map(jnp.asarray, tree))
    leaves = _port_leaves(tree)
    td = TSA.grad_diagnostics(leaves, [list(leaf.params) for leaf in leaves])
    np.testing.assert_allclose(td["norms"].numpy(), np.asarray(jd["norms"]), rtol=1e-6)
    np.testing.assert_allclose(td["quartiles"].numpy(), np.asarray(jd["quartiles"]), rtol=1e-6)
    assert td["names"][td["dominant_idx"]] in jd["names"][int(jd["dominant_idx"])]
    assert "dominant param" in TSA.format_grad_diagnostics(td)


# --------------------------------------------------------------------------
# train_step
# --------------------------------------------------------------------------

def test_train_step_reduces_loss(jparams):
    """AdamW at base_lr 2e-3 overfits a fixed batch in 12 steps (the same
    draws every step), as tests/test_train.py:43-62."""
    m = _model(jparams)
    opt = TStep.make_optimizer(base_lr=2e-3)
    state = TStep.init_train_state(m, opt)
    batch = _tt(_batch())
    losses = []
    for _ in range(12):
        state, metrics = TStep.train_step(state, batch, torch.Generator().manual_seed(42),
                                          cfg=CFG, optimizer=opt, dtype="float32")
        losses.append(float(metrics["loss"]))
        assert np.isfinite(float(metrics["grad_norm"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert state.step == 12 and state.opt_state["count"] == 12


def test_train_step_matches_optax_step(jparams):
    """One port train_step (AdamW) equals JAX's train_step on the same
    objective: the JAX loss's draws are replaced by the port's."""
    m = _model(jparams)
    opt = TStep.make_optimizer(base_lr=1e-2)
    state = TStep.init_train_state(m, opt)
    batch = _batch()
    state, metrics = TStep.train_step(state, _tt(batch), torch.Generator().manual_seed(3),
                                      cfg=CFG, optimizer=opt, dtype="float32")
    stage = TLoss._draw_stage(torch.Generator().manual_seed(3), CFG)
    g = torch.Generator().manual_seed(3)
    TLoss._draw_stage(g, CFG)
    prefix_len, _ = TLoss.sample_nar_prompt(g, torch.tensor(batch["audio_lens"]), 1)
    jb, pe = _jt(batch), JL.make_sine_pe(JCFG.max_position, JCFG.d_model)

    def loss_fn(p):
        return (JLoss.ar_loss(p, JCFG, jb["text_ids"], jb["lang_ids"], jb["text_lens"],
                              jb["codes"][..., 0], jb["audio_lens"], pe, jnp.float32)
                + JLoss.nar_loss(p, JCFG, jb["text_ids"], jb["lang_ids"], jb["text_lens"],
                                 jb["codes"], jb["audio_lens"], jnp.asarray(stage),
                                 jnp.asarray(prefix_len), pe, jnp.float32))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    jopt = JStep.make_optimizer(base_lr=1e-2)
    updates, _ = jopt.update(grads, jopt.init(jparams), jparams)
    want = optax.apply_updates(jparams, updates)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(grads)),
                               rtol=1e-4)
    _assert_tree_close(tree_from_module(m), jax.tree.map(np.asarray, want))


def test_two_stage_masking_freezes_other_stage(jparams):
    """Stage 1 (AR only): the NAR parameters stay bitwise as they were, the
    AR ones move (tests/test_train.py:65-93)."""
    m = _model(jparams)
    leaves = TStep.model_leaves(m)
    before = tree_from_module(m)
    opt = TStep.Masked(TStep.make_optimizer(base_lr=1e-2),
                       [leaf.name.startswith("ar_") for leaf in leaves])
    labels = TV.stage_param_labels(m, 1)
    assert all(v == n.startswith("ar_") for n, v in labels.items())
    assert len(list(TV.stage_parameters(m, 2))) == sum(not v for v in labels.values())
    state = TStep.init_train_state(m, opt)
    TStep.train_step(state, _tt(_batch()), torch.Generator().manual_seed(1), cfg=CFG,
                     optimizer=opt, dtype="float32")
    after = tree_from_module(m)
    np.testing.assert_array_equal(after["nar_text_embedding"]["weight"],
                                  before["nar_text_embedding"]["weight"])
    np.testing.assert_array_equal(after["nar_decoder"]["layers"]["linear1"]["w"],
                                  before["nar_decoder"]["layers"]["linear1"]["w"])
    assert not np.allclose(after["ar_text_embedding"]["weight"],
                           before["ar_text_embedding"]["weight"])
