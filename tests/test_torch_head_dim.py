"""Head dims on the card: the attention kernels are built for 64 and 128, so
another head dim (d_model / num_heads) raises when the pipeline or the
trainer is built for CUDA, before any request or step, naming ROADMAP.md
§3. On the CPU the plain versions take any head dim. No card is needed:
the check runs before anything touches the device."""

import types

import pytest
import torch

from vallex_tpu_torch.config import EngineConfig, ModelConfig
from vallex_tpu_torch.engine.pipeline import SynthesisPipeline
from vallex_tpu_torch.kernels import HEAD_DIMS, check_head_dim
from vallex_tpu_torch.train import trainer


@pytest.mark.parametrize("head_dim, device, raises", [
    (64, "cuda", False), (128, "cuda", False), (32, "cuda", True), (96, "cuda:0", True),
    (16, "cpu", False), (96, "cpu", False),
])
def test_check_head_dim(head_dim, device, raises):
    if raises:
        with pytest.raises(ValueError, match="ROADMAP.md §3"):
            check_head_dim(head_dim, torch.device(device))
    else:
        check_head_dim(head_dim, torch.device(device))
    assert HEAD_DIMS == (64, 128)


def test_pipeline_raises_at_build_time_for_an_unsupported_head_dim():
    """A model on the card (only its device is read before the check) with
    d_model 1024 and 32 heads: head dim 32."""
    model = types.SimpleNamespace(pe=types.SimpleNamespace(device=torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="head dim 32 .*ROADMAP.md §3"):
        SynthesisPipeline(model, ModelConfig(num_heads=32), EngineConfig())


def test_trainer_raises_at_build_time_for_an_unsupported_head_dim(tmp_path):
    """--device cuda with --decoder-dim 64 --nhead 4 (head dim 16): the check
    comes before the model, the data and the device."""
    args = trainer.get_parser().parse_args(
        ["--data-dir", str(tmp_path), "--exp-dir", str(tmp_path / "exp"), "--decoder-dim", "64",
         "--nhead", "4", "--num-decoder-layers", "2", "--device", "cuda"])
    with pytest.raises(ValueError, match="head dim 16 .*ROADMAP.md §3"):
        trainer.run(args)
