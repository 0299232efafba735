"""dp × tp training of the port (parallel/mesh.py, train/distributed.py,
the trainer's --dp / --tp) on gloo CPU ranks, in f32 at the width of the
JAX package's multichip dry run (d 256, 8 heads, 2 layers, FFN 512).

- A (dp 2, tp 2) step of 4 ranks, prefix modes 1 and 2 with the stage and
  prefix fixed: the global loss at 1e-5 relative and every gradient leaf,
  put back together over tp and summed over dp, within 1e-5 of the
  largest gradient entry of the tree of JAX's ar_loss + nar_loss on the
  whole batch (the single-process port is held to JAX leaf by leaf in
  tests/test_torch_train.py); a packed step the same against the port's
  single-process packed step, and its loss within 2e-3 of JAX's unpacked
  losses over the same utterances (as tests/test_torch_train.py holds the
  packed loss).
- ScaledAdam, Eve, AdamW and stage-1 masked ScaledAdam at (2, 2): a step
  has the single process's loss and gradients, and the update of the same
  gradients gives its parameters within 1e-6 of the tree's largest entry
  (a wrong whole-leaf RMS or norm on a rank moves a leaf by a share of
  its ~1e-3 update).
- Uneven splits (B = 3 and B = 1 at dp 2: one rank holds no rows) give the
  single process's gradients; the draws under dp equal the single
  process's; replicated leaves are bitwise equal across the tp ranks.
- A state saved at (1, 2) resumes at (1, 1) to the step that (1, 2) takes.
- compare_to at (2, 2) against the file a (1, 1) step wrote (save_to): the
  numbers worked out on the ranks' own slices equal those of the gathered
  trees.
- The trainer CLI with --dp 2 prints --dp 1's loss lines (to their printed
  4 decimals, 1e-4 relative).
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.models import layers as JL
from vallex_tpu.train import loss as JLoss
from vallex_tpu_torch.config import ModelConfig
from vallex_tpu_torch.data.dataset import collate_packed
from vallex_tpu_torch.models.vallex import init_vallex
from vallex_tpu_torch.parallel.launch import run_ranks
from vallex_tpu_torch.parallel.mesh import make_mesh
from vallex_tpu_torch.train.distributed import StepJob, calls, draw_job, step_job

torch.set_num_threads(1)

KW = dict(d_model=256, num_heads=8, num_layers=2, ffn_dim=512, max_position=512)
JCFG, CFG = JModelConfig(**KW), ModelConfig(**KW)
REPO = Path(__file__).resolve().parents[1]


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _flat(tree, p=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{p}{k}.")
        else:
            yield p + k, np.asarray(v)


TREE = _np(init_vallex(CFG, torch.Generator().manual_seed(0)))


def _batch(B=4, S=16, T=48, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "text_ids": rng.randint(5, 99, (B, S)).astype(np.int32),
        "lang_ids": np.zeros((B, S), np.int32),
        "text_lens": (S - rng.randint(0, 6, B)).astype(np.int32),
        "codes": rng.randint(0, 1024, (B, T, 8)).astype(np.int32),
        "audio_lens": (T - rng.randint(0, 20, B)).astype(np.int32),
    }


def _ranks(dp, tp, job, tmp_path, fn):
    init = f"file://{tmp_path}/pg-{dp}x{tp}-{np.random.randint(1 << 30)}"
    return run_ranks(make_mesh(dp, tp, ["cpu"] * (dp * tp)), fn, job, init_method=init,
                     threads=1, timeout=120)


def _close(got, want, tol, per_leaf=False, what="grads"):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k in want:
        s = float(np.abs(want[k]).max()) if per_leaf else scale
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= tol * max(s, 1e-12), f"{what} {k}: {err} > {tol} x {s}"


def _jax_grads(batch, stage, prefix_len, mode, starts):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pe = JL.make_sine_pe(JCFG.max_position, JCFG.d_model)
    params = jax.tree.map(jnp.asarray, TREE)

    def loss(p):
        return (JLoss.ar_loss(p, JCFG, jb["text_ids"], jb["lang_ids"], jb["text_lens"],
                              jb["codes"][..., 0], jb["audio_lens"], pe, jnp.float32)
                + JLoss.nar_loss(p, JCFG, jb["text_ids"], jb["lang_ids"], jb["text_lens"],
                                 jb["codes"], jb["audio_lens"], jnp.asarray(stage),
                                 jnp.asarray(prefix_len), pe, jnp.float32, prefix_mode=mode,
                                 prompt_starts=None if starts is None
                                 else jnp.asarray(starts, jnp.int32)))

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), jax.tree.map(np.asarray, grads)


# mode: (stage, prefix_len, window starts)
CASES = {1: (3, 5, None), 2: (5, 7, [2, 9, 0, 4])}
OPTS = (("scaled_adam", 0), ("eve", 0), ("adamw", 0), ("scaled_adam", 1))
DRAW_LENS = np.array([40, 31, 57, 22, 48], np.int32)


def _packed_samples():
    rng = np.random.RandomState(5)
    lens_t, lens_a = [12, 9, 15, 7, 11, 14, 8, 10], [40, 29, 44, 51, 33, 47, 38, 30]
    return [{"utt_id": f"u{i}", "text_tokens": rng.randint(5, 99, (sl,)).astype(np.int32),
             "text_tokens_lens": sl, "language": 0,
             "audio_features": rng.randint(0, 1024, (8, al)).astype(np.int32),
             "audio_features_lens": al} for i, (sl, al) in enumerate(zip(lens_t, lens_a))]


def _jobs():
    """The steps every test below reads, by name (one launch a mesh)."""
    packed = {k: v for k, v in collate_packed(_packed_samples(), pack=2).items()
              if k != "utt_ids"}
    jobs = {f"mode{m}": (step_job, StepJob(CFG, TREE, _batch(), prefix_mode=m, draws=CASES[m]))
            for m in CASES}
    jobs["packed"] = (step_job, StepJob(CFG, TREE, packed, packed=True, draws=(3, 5, None)))
    for o, st in OPTS:
        jobs[f"{o}{st}"] = (step_job, StepJob(CFG, TREE, _batch(), optimizer=o, train_stage=st,
                                              seed=3))
    for b in (3, 1):
        jobs[f"B{b}"] = (step_job, StepJob(CFG, TREE, _batch(B=b, seed=b), draws=(2, 4, None)))
    for m in (1, 2):
        jobs[f"draws{m}"] = (draw_job, (CFG, DRAW_LENS, m, 11))
    return jobs


def _launch(dp, tp, jobs, tmp_path):
    names = list(jobs)
    outs = _ranks(dp, tp, [jobs[n] for n in names], tmp_path, fn=calls)
    return [dict(zip(names, o)) for o in outs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three launches: at (1, 2) a state saved after one step and the
    second step; at (1, 1) the jobs and the resumption of that state; at
    (2, 2) the jobs and the updates of (1, 1)'s gradients."""
    tmp = tmp_path_factory.mktemp("pg")
    ckpt = dict(optimizer="scaled_adam", draws=(4, 6, None))
    (saved, _) = _launch(1, 2, {
        "state": (step_job, StepJob(CFG, TREE, _batch(), return_state=True, **ckpt)),
        "two": (step_job, StepJob(CFG, TREE, _batch(), steps=2, **ckpt))}, tmp)
    state = saved["state"]
    jobs = _jobs()
    ref = str(tmp / "ref.pt")
    (one,) = _launch(1, 1, {**jobs, "resumed": (step_job, StepJob(
        CFG, state["params"], _batch(), opt_state=state["opt_state"], start_step=state["step"],
        **ckpt)), "ref": (step_job, StepJob(CFG, TREE, _batch(), draws=CASES[1], save_to=ref))},
        tmp)
    updates = {f"update{o}{st}": (step_job, StepJob(CFG, TREE, {}, optimizer=o, train_stage=st,
                                                    grads=one[f"{o}{st}"]["grads"]))
               for o, st in OPTS}
    updates["compared"] = (step_job, StepJob(CFG, TREE, _batch(), draws=CASES[1],
                                             compare_to=ref))
    many = _launch(2, 2, {**jobs, **updates}, tmp)
    return {"one": one, "many": many, "saved": saved}


def _jax_case(name):
    if name == "packed":
        samples = _packed_samples()
        n = len(samples)
        S = max(s["text_tokens_lens"] for s in samples)
        T = max(s["audio_features_lens"] for s in samples)
        b = {"text_ids": np.full((n, S), 3, np.int32), "lang_ids": np.zeros((n, S), np.int32),
             "text_lens": np.array([s["text_tokens_lens"] for s in samples], np.int32),
             "codes": np.zeros((n, T, 8), np.int32),
             "audio_lens": np.array([s["audio_features_lens"] for s in samples], np.int32)}
        for i, s in enumerate(samples):
            b["text_ids"][i, :s["text_tokens_lens"]] = s["text_tokens"]
            b["codes"][i, :s["audio_features_lens"]] = s["audio_features"].T
        return _jax_grads(b, 3, 5, 1, None)
    m = int(name[-1])
    return _jax_grads(_batch(), *CASES[m][:2], m, CASES[m][2])


@pytest.mark.parametrize("mode", [1, 2])
def test_dp_tp_step_equals_jax_objective(mode, runs):
    """(dp 2, tp 2): the global loss and the whole batch's gradients of
    JAX's objective; replicated leaves bitwise equal on every rank; each
    rank holds its shard of the parameters."""
    want_loss, want_grads = _jax_case(f"mode{mode}")
    outs = [o[f"mode{mode}"] for o in runs["many"]]
    _close(outs[0]["grads"], want_grads, 1e-5)  # rank 0 reports the gathered trees
    for o in outs:
        np.testing.assert_allclose(o["metrics"]["loss"], want_loss, rtol=1e-5)
        assert o["replicated"] == outs[0]["replicated"]
    assert outs[0]["local_params"] < sum(v.size for _, v in _flat(TREE))


def test_dp_tp_packed_step(runs):
    """A packed batch at (2, 2) against the single process at 1e-5; its loss
    against JAX's unpacked losses over the same utterances at 2e-3."""
    one = runs["one"]["packed"]
    outs = [o["packed"] for o in runs["many"]]
    _close(outs[0]["grads"], one["grads"], 1e-5)
    for o in outs:
        np.testing.assert_allclose(o["metrics"]["loss"], one["metrics"]["loss"], rtol=1e-5)
    want_loss, _ = _jax_case("packed")
    np.testing.assert_allclose(outs[0]["metrics"]["loss"], want_loss, rtol=2e-3)


def test_optimizers_match_single_process(runs):
    """ScaledAdam, Eve, AdamW and stage-1 ScaledAdam: a step at (2, 2) has
    (1, 1)'s loss and gradients, and the update of (1, 1)'s gradients at
    (2, 2) (every whole-leaf RMS and norm over the tp slices) gives (1, 1)'s
    parameters within 1e-6 of the tree's largest entry (the full steps
    differ more: Adam's first step is ±lr wherever |g| is near the
    backward's rounding)."""
    one, many = runs["one"], runs["many"]
    for o, st in OPTS:
        _close(many[0][f"{o}{st}"]["grads"], one[f"{o}{st}"]["grads"], 1e-5)
        for m in many:
            np.testing.assert_allclose(m[f"{o}{st}"]["metrics"]["loss"],
                                       one[f"{o}{st}"]["metrics"]["loss"], rtol=1e-5)
        # (1, 1)'s step is its update of these gradients
        _close(many[0][f"update{o}{st}"]["params"], one[f"{o}{st}"]["params"], 1e-6,
               what="params")
    # stage 1: the NAR leaves did not move, the AR ones did
    tree, got = dict(_flat(TREE)), dict(_flat(many[0]["updatescaled_adam1"]["params"]))
    assert not [k for k in tree if k.startswith("nar_") and not np.array_equal(got[k], tree[k])]
    assert not np.array_equal(got["ar_text_embedding.weight"], tree["ar_text_embedding.weight"])


@pytest.mark.parametrize("b", [3, 1])
def test_uneven_splits_match_single_process(b, runs):
    """A batch of 3 and a batch of 1 at dp 2 (with B = 1 one rank holds no
    rows and still joins every collective): (1, 1)'s loss and gradients."""
    one = runs["one"][f"B{b}"]
    _close(runs["many"][0][f"B{b}"]["grads"], one["grads"], 1e-5)
    for o in runs["many"]:
        np.testing.assert_allclose(o[f"B{b}"]["metrics"]["loss"], one["metrics"]["loss"],
                                   rtol=1e-5)


@pytest.mark.parametrize("mode", [1, 2])
def test_draws_under_dp_equal_single_process(mode, runs):
    """The stage, the prefix length and mode 2's window starts (the dp
    ranks' concatenated) under dp 2 over an uneven batch of 5 equal
    draw_step over the whole batch."""
    one = runs["one"][f"draws{mode}"]
    dp0, dp1 = (runs["many"][r][f"draws{mode}"] for r in (0, 2))  # ranks (0, 0), (1, 0)
    assert dp0[:2] == dp1[:2] == one[:2]
    if mode == 2:
        np.testing.assert_array_equal(np.concatenate([dp0[2], dp1[2]]), one[2])


def test_compare_on_slices_equals_gathered_trees(runs):
    """compare_to at (2, 2) against the file (1, 1)'s step wrote: each
    leaf's cosine, largest difference and largest reference entry, worked
    out on the tp ranks' own slices, equal those of the gathered trees of
    the same step against (1, 1)'s (cosine to 1e-9, the maxima to 1e-6 of
    the largest entry); only rank 0 reports them."""
    got = runs["many"][0]["compared"]["compare"]
    assert all("compare" not in o["compared"] for o in runs["many"][1:])
    for kind in ("grads", "params"):
        mine, ref = dict(_flat(runs["many"][0]["mode1"][kind])), dict(_flat(runs["one"]["mode1"][kind]))
        assert set(got[kind]) == set(ref)
        for k, want in ref.items():
            a, b = mine[k].astype(np.float64).ravel(), want.astype(np.float64).ravel()
            na, nb = np.linalg.norm(a), np.linalg.norm(b)
            cos = 1.0 if na == nb == 0 else float(a @ b) / (na * nb)
            c, diff, top = got[kind][k]
            tol = 1e-6 * max(float(np.abs(b).max()), 1e-12)
            assert abs(c - cos) <= 1e-9, (kind, k, c, cos)
            assert abs(diff - float(np.abs(a - b).max())) <= tol, (kind, k)
            assert abs(top - float(np.abs(b).max())) <= tol, (kind, k)


def test_checkpoint_at_1x2_resumes_at_1x1(runs):
    """A full state gathered from (1, 2) after one step continues at (1, 1)
    to the parameters (1, 2) reaches in two steps (1e-5 of the tree's
    scale)."""
    assert runs["saved"]["state"]["opt_state"]["count"] == 1
    _close(runs["one"]["resumed"]["params"], runs["saved"]["two"]["params"], 1e-5,
           what="params")


def test_trainer_cli_dp2_prints_dp1_loss_lines(tmp_path):
    """python -m vallex_tpu_torch.train.trainer --device cpu --dp 2 (two
    rank processes) logs the loss lines of --dp 1, f32, on a tiny HDF5
    set; rank 0 writes the checkpoint."""
    import h5py

    rng = np.random.RandomState(0)
    d = tmp_path / "data"
    d.mkdir()
    lens = [24 + 3 * i for i in range(6)]
    for split in ("train", "valid"):
        with h5py.File(str(d / f"{split}.hdf5"), "w") as f:
            for i, n in enumerate(lens):
                f.create_group(f"utt{i}").create_dataset(
                    "audio", data=rng.randint(0, 1024, (8, n)))
        (d / f"{split}.txt").write_text(
            "".join(f"utt{i}|{n / 75:.2f}|en|tiny utterance {i}\n" for i, n in enumerate(lens)))
    lines = {}
    for dp in (1, 2):
        out = subprocess.run(
            [sys.executable, "-m", "vallex_tpu_torch.train.trainer", "--data-dir", str(d),
             "--exp-dir", str(tmp_path / f"exp{dp}"), "--num-epochs", "2", "--decoder-dim", "64",
             "--nhead", "4", "--num-decoder-layers", "2", "--max-duration", "2.0",
             "--max-cut-duration", "2.0", "--log-interval", "1", "--dtype", "float32",
             "--device", "cpu", "--dp", str(dp)],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-3000:]
        lines[dp] = re.findall(r"epoch (\d+) step (\d+) (.*) \(", out.stderr)
        assert (tmp_path / f"exp{dp}" / f"state-{len(lines[dp]):08d}").exists()
    assert len(lines[1]) == len(lines[2]) >= 2
    for (e1, s1, m1), (e2, s2, m2) in zip(lines[1], lines[2]):
        assert (e1, s1) == (e2, s2)
        v1 = dict(kv.split("=") for kv in m1.split())
        v2 = dict(kv.split("=") for kv in m2.split())
        assert v1.keys() == v2.keys()
        for k in v1:
            assert abs(float(v1[k]) - float(v2[k])) <= 1e-4 * abs(float(v1[k])) + 1e-4, (k, m1, m2)
