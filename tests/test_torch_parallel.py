"""The port's mesh (parallel/mesh.py) and multi-device serving
(engine/batch.py) on the CPU.

- make_mesh's rank map is the (dp, tp) reshape of the JAX package's mesh.
- At the shipped width and tp = 2, every leaf's per-rank shape equals the
  shard shape of the JAX package's layout rule on a 2 × 2 virtual mesh
  (from jax.eval_shape: no full-width array is made), 215,266,308 of
  376,838,148 parameters a rank; at a small width against JAX's
  shard_params itself.
- batch_synthesize over 2 CPU worker processes (1 torch thread each):
  greedy per_chip=1 codes equal the JAX package's batch_synthesize
  (decode_mode "xla") exactly; per_chip=2 codes equal the port's single
  pipeline per request exactly (the dry run's check of JAX's); the pool is
  reused across calls and the mesh closes it (no live child left).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from vallex_tpu.config import EngineConfig as JEngineConfig
from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.engine.batch import batch_synthesize as jax_batch_synthesize
from vallex_tpu.models.vallex import init_vallex as jax_init_vallex
from vallex_tpu.parallel import mesh as JM
from vallex_tpu_torch.config import EngineConfig, ModelConfig
from vallex_tpu_torch.convert import jax_leaves, params_from_jax
from vallex_tpu_torch.engine.batch import batch_synthesize
from vallex_tpu_torch.engine.pipeline import SynthesisPipeline
from vallex_tpu_torch.models.vallex import VALLE
from vallex_tpu_torch.parallel.mesh import leaf_split, make_mesh, shard_params

torch.set_num_threads(1)


@pytest.mark.parametrize("dp,tp", [(2, 4), (4, 2), (8, 1), (1, 8), (2, 2)])
def test_rank_map_is_the_jax_mesh_reshape(dp, tp):
    jmesh = JM.make_mesh(dp=dp, tp=tp, devices=jax.devices()[: dp * tp])
    mesh = make_mesh(dp, tp, ["cpu"] * (dp * tp))
    np.testing.assert_array_equal(mesh.ranks, np.vectorize(lambda d: d.id)(jmesh.devices))
    for r in range(mesh.size):
        assert tuple(np.argwhere(mesh.ranks == r)[0]) == mesh.coords(r)


def _jax_shard_shapes(tree, jmesh):
    """{dotted leaf name: JAX's per-device shape} by shard_params's rule."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            p = f"{path}/{k}" if path else k
            if isinstance(v, dict):
                walk(v, p)
                continue
            try:
                shape = NamedSharding(jmesh, JM.param_partition_spec(p)).shard_shape(v.shape)
            except ValueError:  # shard_params replicates what does not divide
                shape = v.shape
            out[p.replace("/", ".")] = (tuple(shape), tuple(v.shape))

    walk(tree, "")
    return out


def _port_local_shapes(cfg, tp_rank=0):
    with torch.device("meta"):
        model = VALLE(cfg)
    shard_params(model, make_mesh(1, 2, ["cpu"] * 2), tp_rank)
    return {name: ((len(ps),) if stacked else ()) + tuple(ps[0].shape)
            for name, (ps, stacked) in jax_leaves(model).items()}


def test_full_width_tp2_shapes_equal_jax_shards():
    jmesh = JM.make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    shapes = jax.eval_shape(lambda: jax_init_vallex(jax.random.PRNGKey(0), JModelConfig()))
    want = _jax_shard_shapes(shapes, jmesh)
    for rank in (0, 1):
        got = _port_local_shapes(ModelConfig(), rank)
        assert set(got) == set(want)
        for name, (shard, _) in want.items():
            assert got[name] == shard, name
        assert sum(int(np.prod(s)) for s in got.values()) == 215_266_308
    assert sum(int(np.prod(full)) for _, full in want.values()) == 376_838_148
    sharded = sorted(n for n, (shard, full) in want.items() if shard != full)
    assert sharded == sorted([
        "ar_text_embedding.weight", "nar_text_embedding.weight", "ar_audio_embedding.weight",
        "nar_audio_embeddings.weight", "nar_predict_layers.w",
        *(f"{s}.layers.{leaf}" for s in ("ar_decoder", "nar_decoder")
          for leaf in ("self_attn.in_proj_w", "self_attn.in_proj_b", "self_attn.out_w",
                       "linear1.w", "linear1.b", "linear2.w"))])


def test_small_width_shapes_equal_jax_shard_params():
    """Against the arrays JAX's shard_params places (d 256, 8 heads)."""
    kw = dict(d_model=256, num_heads=8, num_layers=2, ffn_dim=512)
    jmesh = JM.make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    sharded = JM.shard_params(jax_init_vallex(jax.random.PRNGKey(0), JModelConfig(**kw)), jmesh)
    got = _port_local_shapes(ModelConfig(**kw))

    def walk(node, path):
        for k, v in node.items():
            p = f"{path}.{k}" if path else k
            if isinstance(v, dict):
                walk(v, p)
            else:
                assert got[p] == v.addressable_shards[0].data.shape, p
                split = leaf_split(p, v.shape, 2)
                assert (split is None) == (v.addressable_shards[0].data.shape == v.shape), p

    walk(sharded, "")


TINY = dict(d_model=64, num_heads=4, num_layers=2, ffn_dim=128)
ECFG = dict(text_buckets=(16,), audio_buckets=(64,), compute_dtype="float32", top_k=1)


def _requests(n, S0, Tp, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        S = S0 + i
        out.append((rng.randint(5, 99, S).astype(np.int32), np.zeros(S, np.int32),
                    rng.randint(0, 1024, (Tp, 8)).astype(np.int32) if i % 2 else None))
    return out


def test_batch_synthesize_per_chip1_equals_jax():
    """Greedy, 2 workers, one request each (one with a prompt): the JAX
    package's batch_synthesize codes exactly; the second call reuses the
    workers; closing the mesh ends them."""
    params = jax_init_vallex(jax.random.PRNGKey(0), JModelConfig(**TINY))
    reqs = _requests(2, 6, 5)
    jmesh = JM.make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    want = jax_batch_synthesize(params, JModelConfig(**TINY), JEngineConfig(**ECFG), jmesh,
                                reqs)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg=ModelConfig(**TINY))
    with make_mesh(2, 1, ["cpu", "cpu"]) as mesh:
        got = batch_synthesize(model, ModelConfig(**TINY), EngineConfig(**ECFG), mesh, reqs)
        pids = [c.proc.pid for c in mesh.serving.children]
        again = batch_synthesize(model, ModelConfig(**TINY), EngineConfig(**ECFG), mesh,
                                 reqs[::-1])
        assert [c.proc.pid for c in mesh.serving.children] == pids
        procs = [c.proc for c in mesh.serving.children]
    assert all(p.poll() is not None for p in procs) and mesh.serving is None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(again, got[::-1]):
        np.testing.assert_array_equal(g, w)


def test_batch_synthesize_per_chip2_equals_single_pipeline():
    """2 workers × 2 requests, each worker's chunk through the batched
    engine (decode_block's plain versions): each request's greedy codes
    equal the single pipeline's (decode_mode "megakernel", K = 4)."""
    cfg = ModelConfig(d_model=256, num_heads=4, num_layers=2, ffn_dim=512)
    e = EngineConfig(text_buckets=(128,), audio_buckets=(512,), compute_dtype="float32",
                     top_k=1, decode_steps=4, decode_mode="megakernel", speculative="off")
    jcfg = JModelConfig(**{k: v for k, v in vars(cfg).items() if k != "ar_stack"})
    params = jax_init_vallex(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg=cfg)
    reqs = _requests(4, 6, 7)
    with make_mesh(2, 1, ["cpu", "cpu"]) as mesh:
        got = batch_synthesize(model, cfg, e, mesh, reqs, per_chip=2, decode_mode="megakernel")
        assert len(mesh.serving.last_launches) == 2
    pipe = SynthesisPipeline(model, cfg, e)
    for i, (text, langs, prompt) in enumerate(reqs):
        want = pipe.synthesize(text, langs, prompt, top_k=1, seed=i, return_wave=False).codes
        np.testing.assert_array_equal(got[i], want)
