"""The port's NAR engine and Vocos vocoder against the JAX package, in fp32
on the CPU.

NAR codes are compared exactly on the valid region, at a small bucket
(plain masked attention) and at s_text + t_audio >= 1536, where the port
routes attention through the flash forward's wrapper (flash_attention_fwd
with segments (ok, ok) and prefix C; its plain version on the CPU) and the
JAX package through its masked path on the CPU. Waveforms: atol = rtol = 1e-4 (the port's irfft against the JAX
package's DFT matmul, both f32) on the valid samples.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu.codec import vocos as JVC
from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.engine import nar as JNAR
from vallex_tpu.models import vallex as JV
from vallex_tpu_torch.codec import vocos as TVC
from vallex_tpu_torch.config import ModelConfig
from vallex_tpu_torch.convert import params_from_jax
from vallex_tpu_torch.engine import nar as TNAR
from vallex_tpu_torch import kernels
from vallex_tpu_torch.kernels import loader

# the module (the package's name `masked_attention` is the function)
MA = importlib.import_module("vallex_tpu_torch.kernels.masked_attention")

torch.set_num_threads(1)

D, H, NL, F = 64, 4, 2, 128
JCFG = JModelConfig(d_model=D, num_heads=H, num_layers=NL, ffn_dim=F)
CFG = ModelConfig(d_model=D, num_heads=H, num_layers=NL, ffn_dim=F)


@pytest.fixture(scope="module")
def both():
    params = JV.init_vallex(jax.random.PRNGKey(9), JCFG)
    return params, params_from_jax(jax.tree.map(np.asarray, params), cfg=CFG)


@pytest.mark.parametrize("t_audio", [64, 1536])
def test_nar_generate_codes_equal(both, t_audio):
    params, model = both
    rng = np.random.RandomState(t_audio)
    s_text, x_len, plen, t_len = 16, 12, 9, 29
    text = np.zeros((1, s_text), np.int64)
    text[0, :x_len] = rng.randint(5, 500, x_len)
    lang = np.zeros((1, s_text), np.int64)
    codes = np.zeros((1, t_audio, 8), np.int64)
    codes[0, :plen] = rng.randint(0, 1024, (plen, 8))
    codes[0, plen:t_len, 0] = rng.randint(0, 1024, t_len - plen)
    j = JNAR.nar_generate(
        params, JCFG, jnp.asarray(text, jnp.int32), jnp.asarray(lang, jnp.int32),
        jnp.asarray(x_len), jnp.asarray(codes, jnp.int32), jnp.asarray(t_len),
        jnp.asarray(plen), s_text=s_text, t_audio=t_audio, compute_dtype="float32")
    loader.reset_launch_counts()
    t = TNAR.nar_generate(model, CFG, torch.from_numpy(text), torch.from_numpy(lang),
                          x_len, torch.from_numpy(codes), t_len, plen,
                          dtype=torch.float32)
    np.testing.assert_array_equal(t[0, :t_len].numpy(), np.asarray(j)[0, :t_len])
    # CPU tensors take the plain versions: no kernel launch is counted
    assert sum(loader.launch_counts.values()) == 0


@pytest.mark.parametrize("rows", [1, 2])
def test_nar_routes_through_flash_forward(both, monkeypatch, rows):
    """At s_text + t_audio >= 1536, nar_generate runs each layer's attention
    through flash_attention_fwd with segments (ok, ok) — ok the key-padding
    rule, 1 on the valid text columns and audio slots — and prefix C, at the
    site of one request or of a batch, and never through masked_attention."""
    _, model = both
    calls = []
    real = TNAR.flash_attention_fwd

    def spy(q, k, v, q_seg, kv_seg, prefix, *, site=""):
        calls.append((q_seg.clone(), kv_seg.clone(), prefix, site))
        return real(q, k, v, q_seg, kv_seg, prefix, site=site)

    def refuse(*args, **kwargs):
        raise AssertionError("the NAR called masked_attention")

    monkeypatch.setattr(TNAR, "flash_attention_fwd", spy)
    for mod in (MA, kernels):
        monkeypatch.setattr(mod, "masked_attention", refuse)
        monkeypatch.setattr(mod, "masked_attention_plain", refuse)
    rng = np.random.RandomState(5)
    s_text, t_audio = 16, 1536
    xl, pl, tl = np.array([12, 5][:rows]), np.array([9, 0][:rows]), np.array([29, 17][:rows])
    codes = np.zeros((rows, t_audio, 8), np.int64)
    for r in range(rows):
        codes[r, : pl[r]] = rng.randint(0, 1024, (pl[r], 8))
        codes[r, pl[r]: tl[r], 0] = rng.randint(0, 1024, tl[r] - pl[r])
    bounds = [int(a[0]) for a in (xl, tl, pl)] if rows == 1 else \
        [torch.from_numpy(a) for a in (xl, tl, pl)]
    TNAR.nar_generate(model, CFG, torch.from_numpy(rng.randint(5, 500, (rows, s_text))),
                      torch.zeros((rows, s_text), dtype=torch.long), bounds[0],
                      torch.from_numpy(codes), bounds[1], bounds[2], dtype=torch.float32)
    C = s_text + t_audio
    cols = np.arange(C)[None, :]
    ok = np.where(cols < s_text, cols < xl[:, None], (cols - s_text) < tl[:, None])
    assert len(calls) == (CFG.num_quantizers - 1) * NL
    for q_seg, kv_seg, prefix, site in calls:
        assert q_seg.dtype == torch.int32 and np.array_equal(q_seg.numpy(), ok.astype(np.int32))
        assert torch.equal(kv_seg, q_seg)
        assert prefix == C
        assert site == (TNAR.SITE if rows == 1 else TNAR.SITE_BATCHED)


def test_vocos_waveform_close():
    params = JVC.init_vocos(jax.random.PRNGKey(1))
    vocos = params_from_jax(jax.tree.map(np.asarray, params))
    rng = np.random.RandomState(2)
    T, t_len = 40, 33
    codes = np.zeros((1, T, 8), np.int64)
    codes[0, :t_len] = rng.randint(0, 1024, (t_len, 8))
    j = np.asarray(JVC.vocos_decode(params, jnp.asarray(codes, jnp.int32), 2,
                                    t_len=jnp.asarray(t_len)))
    t = TVC.vocos_decode(vocos, torch.from_numpy(codes), 2, t_len=t_len).numpy()
    assert t.shape == j.shape == (1, T * TVC.HOP)
    # the valid samples, which the pipeline returns; past t_len both
    # divide by a vanishing window envelope that amplifies f32 rounding
    n = t_len * TVC.HOP
    np.testing.assert_allclose(t[:, :n], j[:, :n], atol=1e-4, rtol=1e-4)
