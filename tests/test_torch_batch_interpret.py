"""The port's batched greedy decode (engine/ar.py::ar_generate_batch)
against the JAX package's ar_generate_batch, whose batched
decode_block_fused Pallas kernel runs in interpret mode on the CPU, as the
JAX package's own tests/test_batch_decode.py runs it: plain, with best_of
samples (the grouped folds) and with the filtered epilogue.

Greedy tokens must be identical per request in fp32. Slow tier: the Pallas
interpreter takes minutes at this width.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu.config import EngineConfig as JEngineConfig
from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.engine import ar as JAR
from vallex_tpu.models import vallex as JV
from vallex_tpu_torch.config import ModelConfig
from vallex_tpu_torch.convert import params_from_jax
from vallex_tpu_torch.engine import ar as TAR
from vallex_tpu_torch.ops.decode_step import pack_layer_weights

pytestmark = pytest.mark.slow  # kernel-interpret tier

torch.set_num_threads(1)

D, H, NL = 256, 4, 2
DIMS = dict(d_model=D, num_heads=H, num_layers=NL, ffn_dim=2 * D)
K = 4


def _reload():
    from vallex_tpu.ops import decode_block as DB
    from vallex_tpu.ops import decode_step as DS
    from vallex_tpu.ops import decode_verify as DV

    importlib.reload(DS)
    importlib.reload(DB)
    importlib.reload(DV)
    importlib.reload(JAR)


def _requests():
    rng = np.random.RandomState(5)
    reqs = []
    for S, Tp in ((12, 17), (9, 150), (14, 0)):
        text = rng.randint(5, 100, size=S).astype(np.int32)
        prompt = rng.randint(0, 1024, size=Tp).astype(np.int32) if Tp else None
        reqs.append((text, np.zeros(S, np.int32), prompt))
    return reqs


def _jax_interpret(monkeypatch, params, reqs, *, best_of=1, top_p=1.0):
    """JAX's ar_generate_batch with its Pallas kernel interpreted, called as
    AREngine.generate_batch calls it at top_k=1. → (per-request tokens,
    avg_logprobs [R, best_of], the scores its best-sample pick used)."""
    jcfg = JModelConfig(**DIMS)
    e = JEngineConfig(text_buckets=(128,), audio_buckets=(512,), compute_dtype="float32",
                      decode_mode="megakernel", decode_steps=K, speculative="off")
    import jax.experimental.pallas as pl_mod

    orig = pl_mod.pallas_call
    monkeypatch.setattr(pl_mod, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    _reload()
    try:
        eng = JAR.AREngine(params, jcfg, e)
        pb = JAR.pad_batched_requests(reqs, jcfg.eos_id, jcfg.num_quantizers,
                                      e.text_buckets, e.audio_buckets)
        quantize = getattr(e, "quantize", "none")
        packed, _ = eng.packed_cache.get(e.compute_dtype, quantize, False)
        y, gen_len, avg = JAR.ar_generate_batch(
            params, jcfg, *(jnp.asarray(pb[n]) for n in (
                "text", "lang", "x_lens", "prompt_pad", "prompt_lens", "caps")),
            jax.random.PRNGKey(3), jnp.asarray(1, jnp.int32), jnp.asarray(1.0, jnp.float32),
            jnp.asarray(top_p, jnp.float32), s_text=pb["s_text"], p_audio=pb["p_audio"],
            t_gen=pb["t_gen"], compute_dtype=e.compute_dtype, greedy=True, quantize=quantize,
            decode_steps=K, plain_sampling=top_p >= 1.0, packed=packed, beams=best_of,
            length_penalty=e.length_penalty)
        y, gen_len = np.asarray(y), np.asarray(gen_len)
        return [y[r, : gen_len[r]] for r in range(len(reqs))], np.asarray(avg)
    finally:
        monkeypatch.undo()
        _reload()


def _port(params, reqs, **knobs):
    cfg = ModelConfig(**DIMS)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg=cfg)
    pb = TAR.pad_batched_requests(reqs, cfg.eos_id, 8, (128,), (512,))
    return TAR.ar_generate_batch(
        model, cfg, pb["text"], pb["lang"], pb["x_lens"], pb["prompt_pad"],
        pb["prompt_lens"], pb["caps"], generator=torch.Generator(), top_k=1,
        temperature=1.0, s_text=pb["s_text"], p_audio=pb["p_audio"], t_gen=pb["t_gen"],
        dtype=torch.float32, decode_steps=K, packed=pack_layer_weights(model, torch.float32),
        **knobs)


@pytest.mark.parametrize("jax_knobs,port_knobs", [
    (dict(best_of=2), dict(beams=2)), (dict(top_p=0.9), dict(top_p=0.9)),
], ids=["grouped-best_of", "filtered-greedy"])
def test_grouped_and_filtered_batch_match_pallas_interpret(monkeypatch, jax_knobs, port_knobs):
    """best_of=2 (JAX's _hbm_fold_batched_grouped) and top_p=0.9 (the
    in-kernel bisection filter) at top_k=1: the port's grouped rows and
    filtered epilogue emit the interpreted kernels' tokens per request, and
    the same per-sample scores (sum of logprobs over length) at rtol 1e-4.
    At top_k=1 the greedy pick ignores the filter, so the filtered case
    checks the routing and the filtered logprob: the top-k keep set of one
    token makes every logprob 0, where the unfiltered epilogue's is the
    full log-softmax. How top_p shapes the kept set and the draw is held
    to JAX per call in tests/test_torch_sampling.py."""
    params = JV.init_vallex(jax.random.PRNGKey(11), JModelConfig(**DIMS))
    reqs = _requests()[:2]
    want, want_scores = _jax_interpret(monkeypatch, params, reqs, **jax_knobs)
    res = _port(params, reqs, **port_knobs)
    for r, w in enumerate(want):
        np.testing.assert_array_equal(res.y_gen[r, : res.gen_len[r]], w,
                                      err_msg=f"request {r}")
    np.testing.assert_allclose(res.scores, want_scores, rtol=1e-4, atol=1e-6)
    if "top_p" in port_knobs:
        assert not np.any(res.scores)


def test_batch_greedy_matches_pallas_interpret(monkeypatch):
    params = JV.init_vallex(jax.random.PRNGKey(11), JModelConfig(**DIMS))
    reqs = _requests()
    want, _ = _jax_interpret(monkeypatch, params, reqs)
    res = _port(params, reqs)
    for r, w in enumerate(want):
        np.testing.assert_array_equal(res.y_gen[r, : res.gen_len[r]], w,
                                      err_msg=f"request {r}")
