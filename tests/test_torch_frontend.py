"""The port's own copies of the JAX-free modules (frontend, presets, config)
and its weight preparation, held against the JAX package.

Exact equality throughout: the frontend is the same Python, the presets the
same files, and int8 quantization is a deterministic rounding of the same
f32 values.
"""

import os

import jax
import numpy as np
import pytest
import torch

from vallex_tpu import api as japi
from vallex_tpu import config as jconfig
from vallex_tpu.frontend import PhonemeTokenizer as JTokenizer
from vallex_tpu.models import vallex as JV
from vallex_tpu.ops import decode_step as JDS
from vallex_tpu_torch import api as tapi
from vallex_tpu_torch import config as tconfig
from vallex_tpu_torch.convert import params_from_jax
from vallex_tpu_torch.frontend import PhonemeTokenizer as TTokenizer
from vallex_tpu_torch.ops import decode_step as TDS

torch.set_num_threads(1)

SENTENCES = [
    "_[EN]Hello world, this is a test of 42 things.[EN]",
    "_[ZH]你好，世界。今天天气很好。[ZH]",
    "_[JA]こんにちは、世界。[JA]",
    "_[ZH]你好[ZH][EN]world[EN]",
]


@pytest.mark.parametrize("text", SENTENCES)
def test_tokenizer_ids_equal(text):
    jid, jl = JTokenizer().tokenize(text)
    tid, tl = TTokenizer().tokenize(text)
    assert tid == jid and tl == jl


def test_presets_equal():
    names = sorted(os.listdir(tapi.PROMPT_SEARCH_DIRS[-1]))
    assert names == sorted(os.listdir(japi.PROMPT_SEARCH_DIRS[-1]))
    assert len(names) == 41
    for n in names:
        a = japi._load_prompt(os.path.join(japi.PROMPT_SEARCH_DIRS[-1], n))
        b = tapi._load_prompt(os.path.join(tapi.PROMPT_SEARCH_DIRS[-1], n))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]


def test_config_copy_equal():
    assert tconfig.ModelConfig() == tconfig.ModelConfig(
        **{f: getattr(jconfig.ModelConfig(), f)
           for f in jconfig.ModelConfig.__dataclass_fields__})
    assert tconfig.model_language_id == jconfig.model_language_id


def test_quantize_weights_equal():
    """int8 values and scales equal the JAX package's, in the port's
    [N, K] layout (the transpose of JAX's [K, N])."""
    cfg = jconfig.ModelConfig(d_model=64, num_heads=4, num_layers=2, ffn_dim=128)
    params = JV.init_vallex(jax.random.PRNGKey(3), cfg)
    jlw = JDS.quantize_weights(JDS.pack_layer_weights(
        params["ar_decoder"]["layers"], np.float32,
        final_norm=params["ar_decoder"]["norm"],
        predict_w=params["ar_predict_layer"]["w"],
        audio_embedding=params["ar_audio_embedding"]["weight"]))
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            cfg=tconfig.ModelConfig(**cfg.__dict__))
    tlw = TDS.quantize_weights(TDS.pack_layer_weights(model, torch.float32))
    for w, s in TDS.QUANTIZED:
        jw = np.asarray(jlw[w])
        np.testing.assert_array_equal(np.swapaxes(jw, -1, -2), tlw[w].numpy())
        np.testing.assert_array_equal(np.asarray(jlw[s]).reshape(tlw[s].shape),
                                      tlw[s].numpy())
