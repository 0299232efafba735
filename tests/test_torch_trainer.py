"""The port's trainer CLI (vallex_tpu_torch/train/trainer.py) on the CPU at
toy width, over a synthetic HDF5 set made as tests/test_train.py:96-145
makes one: one epoch of stage-1 ScaledAdam with a checkpoint, --resume, a
packed run, and --dp / --tp / --init-distributed (the multi-rank runs
against the single process: tests/test_torch_train_parallel.py). --init-checkpoint is
tested in tests/test_torch_checkpoint.py, --visualize-dir and --model-name
in tests/test_torch_vallf.py."""

import os

import numpy as np
import pytest
import torch

from vallex_tpu_torch.train import trainer

torch.set_num_threads(2)

TOY = ["--decoder-dim", "64", "--nhead", "4", "--num-decoder-layers", "2", "--device", "cpu"]


def _data(root, lens):
    import h5py

    rng = np.random.RandomState(0)
    d = root / "data"
    d.mkdir()
    for split in ("train", "valid"):
        with h5py.File(str(d / f"{split}.hdf5"), "w") as f:
            for i, n in enumerate(lens):
                f.create_group(f"utt{i}").create_dataset(
                    "audio", data=rng.randint(0, 1024, (8, n)))
        with open(str(d / f"{split}.txt"), "w") as f:
            for i, n in enumerate(lens):
                f.write(f"utt{i}|{n / 75:.2f}|en|tiny utterance {i}\n")
    return d


def test_trainer_stage1_checkpoint_and_resume(tmp_path):
    """--train-stage 1 with ScaledAdam for one epoch writes state-XXXXXXXX
    and its .json; --resume continues the step count in a second epoch."""
    d = _data(tmp_path, [24 + i for i in range(4)])
    exp = tmp_path / "exp"
    argv = ["--data-dir", str(d), "--exp-dir", str(exp), "--num-epochs", "1",
            "--train-stage", "1", "--log-interval", "1", "--diag-interval", "1",
            "--save-every", "1000", "--valid-interval", "1", "--max-duration", "2.0",
            "--max-cut-duration", "2.0", *TOY]
    out = trainer.run(trainer.get_parser().parse_args(argv))
    assert out["step"] >= 1
    assert np.isfinite(out["metrics"]["loss"]) and np.isfinite(out["metrics"]["grad_norm"])
    ckpts = sorted(p.name for p in exp.iterdir() if p.name.startswith("state-"))
    assert f"state-{out['step']:08d}" in ckpts and f"state-{out['step']:08d}.json" in ckpts
    saved = torch.load(exp / f"state-{out['step']:08d}", weights_only=True)
    assert saved["step"] == out["step"] and saved["opt_state"]["count"] == out["step"]

    args2 = trainer.get_parser().parse_args(argv + ["--resume"])
    args2.num_epochs = 2
    out2 = trainer.run(args2)
    assert out2["step"] > out["step"]
    assert out2["state"].opt_state["count"] == out2["step"]


def test_trainer_packed(tmp_path, monkeypatch):
    """--pack 2: the batch of four arrives packed and trains through
    total_loss_packed; the loss is finite."""
    from vallex_tpu_torch.train import step

    seen = []
    orig = step.train_step

    def spy(*a, **k):
        seen.append(k["packed"])
        return orig(*a, **k)

    monkeypatch.setattr(step, "train_step", spy)
    d = _data(tmp_path, [24 + 7 * i for i in range(4)])
    argv = ["--data-dir", str(d), "--exp-dir", str(tmp_path / "exp"), "--num-epochs", "1",
            "--log-interval", "1", "--diag-interval", "1000", "--save-every", "1000",
            "--valid-interval", "1000", "--max-duration", "4.0", "--max-cut-duration", "2.0",
            "--pack", "2", "--optimizer", "adamw", *TOY]
    out = trainer.run(trainer.get_parser().parse_args(argv))
    assert out["step"] >= 1 and seen and all(seen)
    assert np.isfinite(out["metrics"]["loss"])


@pytest.mark.parametrize("flags, item", [
    pytest.param(["--dp", "2"], "§1 items 7-8", id="flags0-§1 items 7-8"),
    pytest.param(["--tp", "2"], "§1 items 7-8", id="flags1-§1 items 7-8"),
    pytest.param(["--init-distributed"], "§1 items 7-8", id="flags2-§1 items 7-8"),
])
def test_trainer_unported_flags_raise(tmp_path, flags, item, monkeypatch):
    """The flags of ROADMAP §1 items 7-8, now ported: --dp 2 and --tp 2 train
    one epoch on two CPU rank processes and rank 0 writes the checkpoint;
    --init-distributed raises naming torchrun without its environment, and
    with it (a world of one) joins and trains."""
    from vallex_tpu_torch.parallel.launch import free_port

    d = _data(tmp_path, [24 + i for i in range(4)])
    exp = tmp_path / "exp"
    args = trainer.get_parser().parse_args(
        ["--data-dir", str(d), "--exp-dir", str(exp), "--num-epochs", "1", "--log-interval",
         "1", "--max-duration", "2.0", "--max-cut-duration", "2.0", "--dtype", "float32",
         *TOY, *flags])
    if args.init_distributed:
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            monkeypatch.delenv(k, raising=False)
        with pytest.raises(RuntimeError, match="RANK is not set.*torchrun"):
            trainer.run(args)
        for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                     ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(free_port()))):
            monkeypatch.setenv(k, v)
    out = trainer.run(args)
    assert item == "§1 items 7-8" and out["step"] >= 1
    assert np.isfinite(out["metrics"]["loss"])
    assert os.path.exists(exp / f"state-{out['step']:08d}")
