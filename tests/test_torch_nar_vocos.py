"""The port's NAR engine and Vocos vocoder against the JAX package, in fp32
on the CPU.

NAR codes are compared exactly on the valid region, at a small bucket
(plain masked attention) and at s_text + t_audio >= 1536, where the port
routes attention through the masked_attention kernel's wrapper (its plain
version on the CPU) and the JAX package through its masked path on the
CPU. Waveforms: atol = rtol = 1e-4 (the port's irfft against the JAX
package's DFT matmul, both f32) on the valid samples.
"""

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
from vallex_tpu_torch.kernels import loader

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
