"""The port's AR decode operations (ops/decode_block.py, ops/decode_verify.py,
ops/sampling.py) against the JAX package, in fp32 on the CPU.

Both sides start from the same JAX prefill; the JAX side then runs its
per-token XLA decode step (encoder_layer_decode_step) greedily. The port's
draft block must feed the same tokens and produce the same per-step logits,
and its verify pass must reproduce the logits and KV columns at all K
positions at once. Tolerance: atol = rtol = 1e-4 on logits and KV columns;
tokens exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.engine import ar as JAR
from vallex_tpu.models import layers as JL
from vallex_tpu.models import vallex as JV
from vallex_tpu_torch.config import ModelConfig
from vallex_tpu_torch.convert import params_from_jax
from vallex_tpu_torch.ops.decode_block import decode_block_fused
from vallex_tpu_torch.ops.decode_step import pack_layer_weights
from vallex_tpu_torch.ops.decode_verify import decode_verify
from vallex_tpu_torch.ops.sampling import speculative_accept

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
D, H, NL, F = 64, 4, 2, 128
HD = D // H
JCFG = JModelConfig(d_model=D, num_heads=H, num_layers=NL, ffn_dim=F)
CFG = ModelConfig(d_model=D, num_heads=H, num_layers=NL, ffn_dim=F)
S_TEXT, P_AUDIO, T_AUDIO, X_LEN, PLEN = 16, 8, 32, 11, 5
C = S_TEXT + T_AUDIO
K = 8
EOS = 1024


@pytest.fixture(scope="module")
def reference():
    """JAX prefill + K greedy per-token steps → caches after prefill, the
    tokens t0..tK and the logits after feeding each of t0..t(K-1)."""
    params = JV.init_vallex(jax.random.PRNGKey(5), JCFG)
    rng = np.random.RandomState(0)
    text = np.zeros((1, S_TEXT), np.int32)
    text[0, :X_LEN] = rng.randint(5, 500, X_LEN)
    lang = np.zeros((1, S_TEXT), np.int32)
    prompt = np.full((1, P_AUDIO - 1), EOS, np.int32)
    prompt[0, :PLEN] = rng.randint(0, 1024, PLEN)
    pe = JL.make_sine_pe(JCFG.max_position, D)
    x = JV.text_input(params, JCFG, text, lang, "ar", pe)
    y = np.concatenate([[[JCFG.bos_id]], prompt], axis=1)
    h = jnp.concatenate([x, JV.ar_audio_input(params, JCFG, y, pe)], axis=1)
    mask = JAR._prefill_mask(S_TEXT, P_AUDIO, X_LEN, PLEN)
    layers = [jax.tree.map(lambda a, i=i: a[i], params["ar_decoder"]["layers"])
              for i in range(NL)]
    ck = np.zeros((NL, 1, H, C, HD), np.float32)
    cv = np.zeros_like(ck)
    for i, lp in enumerate(layers):
        h, k, v = JL.encoder_layer_prefill(lp, h, H, mask)
        ck[i, :, :, : S_TEXT + P_AUDIO] = k
        cv[i, :, :, : S_TEXT + P_AUDIO] = v
    h = JL.layer_norm_apply(params["ar_decoder"]["norm"], h)
    prefill = (ck.copy(), cv.copy())
    logits = JV.ar_logits(params, h[:, S_TEXT + PLEN])
    jck, jcv = jnp.asarray(ck), jnp.asarray(cv)
    toks, step_logits = [], []
    for t in range(K):
        tok = int(jnp.argmax(logits[0]))
        toks.append(tok)
        pos = PLEN + 1 + t
        hh = JV.ar_audio_input(params, JCFG, np.array([[tok]]), pe, pos)
        kv_mask = JAR._audio_kv_mask(C, S_TEXT, X_LEN, pos)
        new_k, new_v = [], []
        for i, lp in enumerate(layers):
            hh, k_i, v_i = JL.encoder_layer_decode_step(
                lp, hh, jck[i], jcv[i], S_TEXT + pos, H, kv_mask)
            new_k.append(k_i)
            new_v.append(v_i)
        jck, jcv = jnp.stack(new_k), jnp.stack(new_v)
        hh = JL.layer_norm_apply(params["ar_decoder"]["norm"], hh)
        logits = JV.ar_logits(params, hh[:, 0])
        step_logits.append(np.asarray(logits[0]))
    toks.append(int(jnp.argmax(logits[0])))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg=CFG)
    return dict(model=model, prefill=prefill, toks=toks,
                logits=np.stack(step_logits), caches=(np.asarray(jck), np.asarray(jcv)))


def _port_caches(prefill):
    ck, cv = (torch.zeros((NL, H, C + K, HD)) for _ in range(2))
    ck[:, :, :C] = torch.from_numpy(prefill[0][:, 0])
    cv[:, :, :C] = torch.from_numpy(prefill[1][:, 0])
    return ck, cv


def test_decode_block_greedy_matches_per_token(reference):
    """K-1 greedy draft steps (fp32 weights): fed tokens, next token and
    every step's logits equal the JAX per-token loop's."""
    r = reference
    lw = pack_layer_weights(r["model"], torch.float32)
    ck, cv = _port_caches(r["prefill"])
    out = decode_block_fused(
        torch.tensor([r["toks"][0]]), torch.zeros(1), torch.zeros(1, dtype=torch.bool),
        torch.zeros(1), lw, ck, cv, r["model"].pe, x_len=X_LEN, audio_pos=PLEN + 1,
        remaining=2 ** 30, temperature=1.0, steps=K - 1, s_text=S_TEXT,
        vocab=1025, eos=EOS, stochastic=False)
    assert out.fed.tolist() == r["toks"][: K - 1]
    assert int(out.next_tok[0]) == r["toks"][K - 1]
    np.testing.assert_allclose(out.step_logits[:, :1025].numpy(),
                               r["logits"][: K - 1], **TOL)
    assert not bool(out.done[0])


def test_decode_block_bookkeeping_cap_and_eos(reference):
    """Steps at or past `remaining` feed EOS and set done; logprobs add up
    only while alive."""
    r = reference
    lw = pack_layer_weights(r["model"], torch.float32)
    ck, cv = _port_caches(r["prefill"])
    out = decode_block_fused(
        torch.tensor([r["toks"][0]]), torch.tensor([-0.5]), torch.zeros(1, dtype=torch.bool),
        torch.zeros(1), lw, ck, cv, r["model"].pe, x_len=X_LEN, audio_pos=PLEN + 1,
        remaining=3, temperature=1.0, steps=5, s_text=S_TEXT, vocab=1025,
        eos=EOS, stochastic=False)
    assert out.fed.tolist()[:3] == r["toks"][:3]
    assert out.fed.tolist()[3:] == [EOS, EOS]
    assert bool(out.done[0])
    # logprobs of the 3 live fed tokens: -0.5 for t0, then the two sampled
    lp = torch.log_softmax(out.step_logits[:2, :1025], -1)
    want = -0.5 + sum(float(lp[i, r["toks"][i + 1]]) for i in range(2))
    np.testing.assert_allclose(float(out.sum_logprobs[0]), want, **TOL)


def test_decode_verify_matches_per_token(reference):
    """One pass over K positions == K per-token steps: logits at every
    position and the K KV columns of every layer."""
    r = reference
    lw = pack_layer_weights(r["model"], torch.float32)
    ck, cv = _port_caches(r["prefill"])
    logits = decode_verify(torch.tensor(r["toks"][:K]), lw, ck, cv, r["model"].pe,
                           x_len=X_LEN, audio_pos=PLEN + 1, s_text=S_TEXT)
    np.testing.assert_allclose(logits[:, :1025].numpy(), r["logits"], **TOL)
    assert torch.argmax(logits[:, :1025], -1).tolist() == r["toks"][1:]
    slots = slice(S_TEXT + PLEN + 1, S_TEXT + PLEN + 1 + K)
    np.testing.assert_allclose(ck[:, :, slots].numpy(), r["caches"][0][:, 0, :, slots], **TOL)
    np.testing.assert_allclose(cv[:, :, slots].numpy(), r["caches"][1][:, 0, :, slots], **TOL)


# --- speculative_accept: distribution exactness (Monte-Carlo) ----------------

V_SMALL, K_SMALL, TRIALS = 8, 4, 12000


def _marginal(p_logits, q_logits, temp=1.0):
    g = torch.Generator().manual_seed(0)
    counts = np.zeros(V_SMALL)
    ms = []
    for _ in range(TRIALS):
        u = torch.rand((K_SMALL - 1, V_SMALL), generator=g)
        draft = torch.argmax(q_logits / temp - torch.log(-torch.log(u)), -1)
        emit, _, m = speculative_accept(draft, q_logits, p_logits, temp, g)
        counts[int(emit[0])] += 1
        ms.append(int(m))
    return counts / TRIALS, float(np.mean(ms))


def test_speculative_accept_marginal_matches_target():
    """Emitted tokens follow p even under a mismatched proposal q. atol
    0.02 is > 4 standard deviations of a 12000-trial frequency."""
    rng = np.random.RandomState(0)
    p = torch.from_numpy((rng.randn(K_SMALL, V_SMALL) * 1.5).astype(np.float32))
    q = torch.from_numpy((rng.randn(K_SMALL - 1, V_SMALL) * 1.5).astype(np.float32))
    emp, _ = _marginal(p, q)
    np.testing.assert_allclose(emp, torch.softmax(p[0], -1).numpy(), atol=0.02)


def test_speculative_accept_perfect_proposal_accepts_all():
    rng = np.random.RandomState(1)
    p = torch.from_numpy(rng.randn(K_SMALL, V_SMALL).astype(np.float32))
    g = torch.Generator().manual_seed(1)
    for _ in range(200):
        draft = torch.randint(0, V_SMALL, (K_SMALL - 1,), generator=g)
        _, logp, m = speculative_accept(draft, p[: K_SMALL - 1], p, 1.0, g)
        assert int(m) == K_SMALL - 1
        assert torch.isfinite(logp).all()
