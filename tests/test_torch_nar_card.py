"""The NAR's attention route on the card (engine/nar.py::flash_route):
nar_generate at the offline benchmark cells' shape (48 rows, C = 256 +
1024, bf16, the shipped width at head dim 64 and 128) runs every layer's attention through the
flash forward and matches the masked core, as chip_smoke.py's phase 3g
holds it (`nar_cell_check`). The route itself is tested on the CPU in
tests/test_torch_nar_vocos.py. The `card` test needs a CUDA device and
skips without one; this file imports no JAX, so on the card:

    python -m pytest --noconftest tests/test_torch_nar_card.py -m card
"""

import os
import sys

import pytest
import torch

from vallex_tpu_torch.config import ModelConfig
from vallex_tpu_torch.convert import load_tree
from vallex_tpu_torch.models.vallex import VALLE, init_vallex

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card:"
                    " python -m pytest --noconftest tests/test_torch_nar_card.py -m card")


@pytest.mark.card
@pytest.mark.parametrize("head_dim", [64, 128])
def test_card_nar_cell_shape_runs_flash(card, head_dim):
    """At the shipped width (16 heads of 64, or 8 of 128): 84 flash launches
    at flash_attention_batched and no masked core; each launch's output
    within the flash rows' rule of the masked core's; against the stages
    in f32 arithmetic, the flash route's codes as accurate as the masked
    core's (within 3 sqrt of the rows where the two differ)."""
    cfg = ModelConfig(num_heads=ModelConfig().d_model // head_dim)
    assert cfg.head_dim == head_dim
    model = load_tree(VALLE(cfg), init_vallex(cfg, torch.Generator().manual_seed(0)),
                      dtype=torch.bfloat16, device="cuda")
    seen = chip_smoke.nar_cell_check(torch.device("cuda"), model)
    assert seen["launches"] == {("flash_attention_fwd", "flash_attention_batched"):
                                (cfg.num_quantizers - 1) * cfg.num_layers}
    assert seen["core_calls"] == 0
    assert seen["worst"] <= 1.0
    assert seen["compared"] > 0 and seen["off_f32_flash"] <= seen["allowed"]
