"""The port's flash-route training loss against the JAX package's flash
route, whose Pallas kernels (the library's flash attention and its
backward, prefix-causal for the AR) run in interpret mode, at the sizes of
tests/test_train.py:380-421 (B = 2, S = 100, T = 120: not a multiple of
the Pallas blocks, so JAX pads to them and the port does not).

Slow tier: the interpreted kernels take minutes under autodiff.
Tolerances: the loss within 1e-3 and every gradient leaf at rtol = atol =
2e-3, as tests/test_train.py:417-421.
"""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.models import layers as JL
from vallex_tpu.models import vallex as JV
from vallex_tpu.train import loss as JLoss
from vallex_tpu_torch.config import ModelConfig
from vallex_tpu_torch.convert import params_from_jax, tree_from_module
from vallex_tpu_torch.train import loss as TLoss

pytestmark = pytest.mark.slow  # kernel-interpret tier

KW = dict(d_model=64, num_heads=4, num_layers=2, ffn_dim=128, max_position=256)


@pytest.mark.parametrize("mode", [1, 0])
def test_flash_total_loss_matches_pallas_interpret(monkeypatch, mode):
    jcfg, cfg = JModelConfig(**KW), ModelConfig(**KW)
    params = JV.init_vallex(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(7)
    B, S, T = 2, 100, 120
    b = {"text_ids": rng.randint(5, 99, (B, S)).astype(np.int32),
         "lang_ids": np.zeros((B, S), np.int32),
         "text_lens": np.array([S, S - 13], np.int32),
         "codes": rng.randint(0, 1024, (B, T, 8)).astype(np.int32),
         "audio_lens": np.array([T, T - 37], np.int32)}
    stage, prefix_len = 4, (0 if mode == 0 else 9)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    pe = JL.make_sine_pe(jcfg.max_position, jcfg.d_model)

    def jloss(p):
        return (JLoss.ar_loss(p, jcfg, jb["text_ids"], jb["lang_ids"], jb["text_lens"],
                              jb["codes"][..., 0], jb["audio_lens"], pe, jnp.float32,
                              use_flash=True)
                + JLoss.nar_loss(p, jcfg, jb["text_ids"], jb["lang_ids"], jb["text_lens"],
                                 jb["codes"], jb["audio_lens"], jnp.asarray(stage),
                                 jnp.asarray(prefix_len), pe, jnp.float32, prefix_mode=mode,
                                 use_flash=True))

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    want_loss, want_grads = jax.value_and_grad(jloss)(params)

    m = params_from_jax(jax.tree.map(np.asarray, params), cfg=cfg).requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss = (TLoss.ar_loss(m, cfg, tb["text_ids"], tb["lang_ids"], tb["text_lens"],
                          tb["codes"][..., 0], tb["audio_lens"], torch.float32, use_flash=True)
            + TLoss.nar_loss(m, cfg, tb["text_ids"], tb["lang_ids"], tb["text_lens"],
                             tb["codes"], tb["audio_lens"], stage, prefix_len, torch.float32,
                             prefix_mode=mode, use_flash=True))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) < 1e-3
    got = tree_from_module(m, grad=True)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want_grads)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-3, atol=2e-3,
                                   err_msg=jax.tree_util.keystr(path))
